"""PyTorch port, bf16 mixed-precision training (ROADMAP item 1): kernel 9
(the flash backward) in bf16, held against the JAX package on the CPU:
bwd_plain on bf16 operands against the JAX Pallas kernel (interpret mode)
on the same values, FlashApply's bf16 gradients against jax.vjp of the JAX
flash_apply in bf16, and the band GAT's bf16 Trainer against the JAX bf16
Trainer (the rest of the slice: tests/test_torch_bf16_training.py, whose
helpers and tolerances this file shares).

Tolerances (stated in full in tests/test_torch_bf16_training.py): dv
within 2 bf16 ulps of the larger value, taken at no less than 1e-3 of
max|dv|; da2 and the folded da1 within 1e-3 of their largest magnitude;
FlashApply's bf16 gradients within 1e-2 of their largest magnitude; the
trainer's first-step gradients within 2e-2 of each leaf's largest
magnitude, its 3 losses within rtol 0.05 and atol 0.02.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from graph_neural_networks_torch.ops import attention_flash as taf
from graph_neural_networks_torch.ops import gso as tgso
from graph_neural_networks_tpu.ops import attention_flash as jaf
from graph_neural_networks_tpu.ops import gso as jgso
from tests.test_torch_bf16_training import (BF, DV_ULPS, F32_REL, GRAD_REL,
                                            _aux_bf16, _bf, _jaux_bf16, _jbf,
                                            _rel, _ulps, check_trainer,
                                            sbm_data)  # noqa: F401
from tests.test_torch_flash_bwd import _chunk_graph, _empty_subchunks
from tests.test_torch_flash_bwd import _operands as _flash_operands


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine: one intra-op thread
    keeps the many small torch ops here from oversubscribing its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("with_s", [True, False])
@pytest.mark.parametrize("kind", ["empty", "full"])
def test_bwd_plain_bf16_matches_jax_kernel(kind, with_s):
    """bwd_plain on bf16 operands (f32 stats) against JAX _bwd_call on the
    same bf16 values, on a graph whose window has 64 x 64 tiles without
    support (what kernel 9b skips) and on one without: da2 and da1p f32,
    dv bf16 on both sides."""
    ibs, Q, F = 64, 3, 8
    S = _chunk_graph(kind)
    N = S.shape[-1]
    tg = tgso.as_gso(S, mode="band", block_size=ibs, device="cpu")
    jg = jgso.as_gso(S, mode="band", block_size=ibs)
    w = tg.band_w
    aux = _aux_bf16(taf.band_auxes(tg)[0])
    empty, total = _empty_subchunks(aux.mask_row.float().numpy(), w)
    assert total > 0 and (empty > 0 if kind == "empty" else empty == 0)
    rng = np.random.default_rng(21)
    a1, a2 = (_bf(rng.standard_normal((Q, N))) for _ in range(2))
    v, g = (_bf(rng.standard_normal((Q, F, N))) for _ in range(2))
    mx, sm = taf.stats_plain(a1, a2, aux.mask_row, w=w, ibs=ibs)
    jaux = _jaux_bf16(jg, w)
    stats = (jnp.asarray(t.numpy().reshape(Q, -1, 1, ibs)) for t in (mx, sm))
    with pltpu.force_tpu_interpret_mode():
        jda2, jda1, jdv = jaf._bwd_call(
            _jbf(a1), _jbf(a2), _jbf(v), *stats, jaux.slab_row,
            jaux.mask_row, _jbf(g), w, ibs, with_s, 0.2, True)
    da2, da1p, dv = taf.bwd_call(a1, a2, v, mx, sm, aux.slab_col,
                                 aux.mask_row, g, w=w, ibs=ibs,
                                 with_s=with_s)
    assert da2.dtype == da1p.dtype == torch.float32 and dv.dtype == BF
    assert jdv.dtype == jnp.bfloat16
    assert _rel(da2, jda2) <= F32_REL
    assert _rel(taf.fold_window_partials(da1p, w), jda1) <= F32_REL
    assert _ulps(dv, jdv) <= DV_ULPS


def test_bwd_bf16_wrapper_checks_its_kernel_limits():
    """The bf16 backward takes at most BWD_BF16_MAX_F features; the
    wrapper says so before it reaches the library."""
    with pytest.raises(ValueError, match="F <= 64"):
        taf._check_bwd_smem("bwd_call", 2, 128, 65, BF)


@pytest.mark.parametrize("with_s", [True, False])
def test_flash_apply_bf16_grads_match_jax(with_s):
    """FlashApply's gradients in a1x, a2x and v on bf16 operands against
    jax.vjp of the JAX flash_apply on the same bf16 values: each in the
    operands' dtype (da1 and da2 rounded once, after the fold)."""
    tg, jg, a1, a2, v, g = _flash_operands(90, 50, 16, 2, 3, seed=17)
    w = tg.band_w
    jaux = _jaux_bf16(jg, w)
    aux = _aux_bf16(taf.band_auxes(tg)[0])
    ta = [_bf(t).requires_grad_() for t in (a1, a2, v)]
    gb = _bf(g)
    y = taf.flash_apply(*ta, aux, w, 16, with_s)
    assert y.dtype == BF
    y.backward(gb)
    with pltpu.force_tpu_interpret_mode():
        jy, vjp = jax.vjp(
            lambda x1, x2, vv: jaf.flash_apply(x1, x2, vv, jaux, w, 16,
                                               with_s, True, 0.2),
            *(_jbf(t.detach()) for t in ta))
        want = vjp(_jbf(gb))
    assert _ulps(y, jy) <= DV_ULPS
    for t, jw in zip(ta, want):
        assert t.grad.dtype == BF and jw.dtype == jnp.bfloat16
        assert _rel(t.grad, jw) <= GRAD_REL


def test_gat_trainer_bf16_matches_jax(sbm_data, tmp_path, monkeypatch):
    """The band GAT ([1, 4, 4] features, 2 heads) trained in bf16 through
    FlashApply (kernels 7-8 forward, kernel 9 backward, all bf16): see
    tests/test_torch_bf16_training.py:check_trainer."""
    check_trainer("gat_band", sbm_data, tmp_path, monkeypatch)
