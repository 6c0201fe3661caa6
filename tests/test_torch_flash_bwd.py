"""PyTorch port, the flash backward: ops/attention_flash.py's bwd_plain,
fold_window_partials, FlashApply and the gradients of the three flash
entry points, held against the JAX package on the CPU.

The JAX Pallas kernels run with interpret=True under
pltpu.force_tpu_interpret_mode(), as tests/test_attention_flash.py runs
them. Every S is non-symmetric, so a swapped row/column layout fails.

Tolerance atol = rtol = 1e-4: f32 softmax VJPs summed in another order on
both sides (exp from another library); the float64 gradcheck uses its own
defaults.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from graph_neural_networks_torch.ops import attention_band as tab
from graph_neural_networks_torch.ops import attention_flash as taf
from graph_neural_networks_torch.ops import gso as tgso
from graph_neural_networks_tpu.ops import attention_flash as jaf
from graph_neural_networks_tpu.ops import filters as jfilters
from graph_neural_networks_tpu.ops import gso as jgso

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine: one intra-op thread
    keeps the many small torch ops here from oversubscribing its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graph(N, half, E, seed):
    """E non-symmetric banded GSOs, nonzeros within `half` of the diagonal
    (for half = 0: inside the diagonal blocks of 16)."""
    rng = np.random.default_rng(seed)
    S = np.zeros((E, N, N), np.float32)
    for e in range(E):
        ii = rng.integers(0, N, 4 * N)
        if half == 0:
            jj = ii // 16 * 16 + rng.integers(0, 16, len(ii))
        else:
            jj = ii + rng.integers(-half, half + 1, len(ii))
        ok = (jj >= 0) & (jj < N)
        S[e, ii[ok], jj[ok]] = rng.random(ok.sum())
    assert not np.allclose(S, np.swapaxes(S, 1, 2))
    return S


def _operands(N, half, ibs, Q, F, seed, E=1):
    """torch and JAX band Gsos, and padded a1, a2, v, g (numpy)."""
    S = _graph(N, half, E, seed)
    tg = tgso.as_gso(S, mode="band", block_size=ibs, device="cpu")
    jg = jgso.as_gso(S, mode="band", block_size=ibs)
    Np = tg.s_band.shape[1] * ibs
    rng = np.random.default_rng(seed + 50)

    def pad(*shape):
        return np.pad(rng.standard_normal(shape).astype(np.float32),
                      [(0, 0)] * (len(shape) - 1) + [(0, Np - N)])
    return tg, jg, pad(Q, N), pad(Q, N), pad(Q, F, N), pad(Q, F, N)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# (N, half, ibs, block bandwidth w): ragged N throughout
BWD_CASES = [(90, 0, 16, 0), (90, 12, 16, 1), (90, 44, 16, 3),
             (150, 40, 32, 2)]
BWD_IDS = ["w0", "w1", "w3", "ibs32"]


@pytest.mark.parametrize("with_s", [True, False])
@pytest.mark.parametrize("N,half,ibs,w", BWD_CASES, ids=BWD_IDS)
def test_bwd_plain_matches_jax_kernel(N, half, ibs, w, with_s):
    """bwd_plain + fold against JAX _bwd_call on its slab_row layout."""
    tg, jg, a1, a2, v, g = _operands(N, half, ibs, 3, 5, seed=N + half)
    assert tg.band_w == w
    taux = taf.band_auxes(tg)[0]
    mx, sm = taf.stats_plain(*_t(a1, a2), taux.mask_row, w=w, ibs=ibs)
    jaux = jaf._auxes(jfilters._slab5(jg), w)[0]
    stats = (t.numpy().reshape(3, -1, 1, ibs) for t in (mx, sm))
    with pltpu.force_tpu_interpret_mode():
        jda2, jda1, jdv = jaf._bwd_call(
            *_j(a1, a2, v, *stats), jaux.slab_row,
            jaux.mask_row, jnp.asarray(g), w, ibs, with_s, 0.2, True)
    da2, da1p, dv = taf.bwd_call(*_t(a1, a2, v), mx, sm, taux.slab_col,
                                 taux.mask_row, *_t(g), w=w, ibs=ibs,
                                 with_s=with_s)
    assert da1p.shape == (3, tg.s_band.shape[1], 2 * w + 1, ibs)
    np.testing.assert_allclose(da2.numpy(), np.asarray(jda2), **TOL)
    np.testing.assert_allclose(taf.fold_window_partials(da1p, w).numpy(),
                               np.asarray(jda1), **TOL)
    np.testing.assert_allclose(dv.numpy(), np.asarray(jdv), **TOL)
    assert taf.bwd_call.launches == 0   # CPU tensors: the plain version


def _chunk_graph(kind, N=320, ibs=64, seed=3):
    """A non-symmetric band GSO at the kernel's 64-node granularity:
    'empty' has nonzeros within 40 of the diagonal plus two 100 apart (one
    two blocks off the diagonal), so its block bandwidth is 2 and most
    64 x 64 tiles of its outer window blocks hold no support; 'full' fills every block within one of the
    diagonal (w = 1), so no tile of its window is empty."""
    rng = np.random.default_rng(seed)
    blk = np.arange(N) // ibs
    if kind == "full":
        near = np.abs(blk[:, None] - blk[None]) <= 1
        return (rng.random((1, N, N)) * near).astype(np.float32)
    S = np.zeros((1, N, N), np.float32)
    ii = rng.integers(0, N, 4 * N)
    jj = ii + rng.integers(-40, 41, len(ii))
    ok = (jj >= 0) & (jj < N)
    S[0, ii[ok], jj[ok]] = rng.random(ok.sum())
    S[0, [5, 200], [105, 100]] = 0.5          # two entries 100 apart
    return S


def _empty_subchunks(mask_row, w, sub=64):
    """(tiles of sub x sub nodes of the row-window mask inside the matrix
    without support, all inside the matrix): what the CUDA backward
    skips, from the mask in numpy."""
    mr = np.asarray(mask_row)
    nb, W, ibs, _ = mr.shape
    empty = total = 0
    for i in range(nb):
        for k in range(W):
            if not 0 <= i + k - w < nb:
                continue
            for r in range(0, ibs, sub):
                for c in range(0, ibs, sub):
                    total += 1
                    empty += not mr[i, k, r:r + sub, c:c + sub].any()
    return empty, total


@pytest.mark.parametrize("with_s", [True, False])
@pytest.mark.parametrize("kind", ["empty", "full"])
def test_bwd_plain_matches_jax_with_and_without_empty_chunks(kind, with_s):
    """bwd_plain + fold against JAX _bwd_call on a graph where the CUDA
    kernel skips sub-chunks without support and on one where it skips
    none (the plain version computes every score either way)."""
    ibs, Q, F = 64, 3, 8
    S = _chunk_graph(kind)
    N = S.shape[-1]
    tg = tgso.as_gso(S, mode="band", block_size=ibs, device="cpu")
    jg = jgso.as_gso(S, mode="band", block_size=ibs)
    w = tg.band_w
    assert w == (2 if kind == "empty" else 1)
    taux = taf.band_auxes(tg)[0]
    empty, total = _empty_subchunks(taux.mask_row.numpy(), w)
    assert total > 0 and (empty > 0 if kind == "empty" else empty == 0)
    rng = np.random.default_rng(11)
    a1, a2 = (rng.standard_normal((Q, N)).astype(np.float32)
              for _ in range(2))
    v, g = (rng.standard_normal((Q, F, N)).astype(np.float32)
            for _ in range(2))
    mx, sm = taf.stats_plain(*_t(a1, a2), taux.mask_row, w=w, ibs=ibs)
    jaux = jaf._auxes(jfilters._slab5(jg), w)[0]
    stats = (t.numpy().reshape(Q, -1, 1, ibs) for t in (mx, sm))
    with pltpu.force_tpu_interpret_mode():
        jda2, jda1, jdv = jaf._bwd_call(
            *_j(a1, a2, v, *stats), jaux.slab_row, jaux.mask_row,
            jnp.asarray(g), w, ibs, with_s, 0.2, True)
    da2, da1p, dv = taf.bwd_call(*_t(a1, a2, v), mx, sm, taux.slab_col,
                                 taux.mask_row, *_t(g), w=w, ibs=ibs,
                                 with_s=with_s)
    np.testing.assert_allclose(da2.numpy(), np.asarray(jda2), **TOL)
    np.testing.assert_allclose(taf.fold_window_partials(da1p, w).numpy(),
                               np.asarray(jda1), **TOL)
    np.testing.assert_allclose(dv.numpy(), np.asarray(jdv), **TOL)


@pytest.mark.parametrize("N,half,ibs,w", BWD_CASES, ids=BWD_IDS)
def test_slab_col_mirrored_index_is_jax_slab_row(N, half, ibs, w):
    """slab_row[i, k] = slab_col[i + k - w, 2w - k]: the index the CUDA
    kernel reads, bit for bit against the JAX package's slab_row."""
    tg, jg, *_ = _operands(N, half, ibs, 1, 1, seed=N + half)
    slab_col = taf.band_auxes(tg)[0].slab_col.numpy()
    nb, W = slab_col.shape[:2]
    want = np.asarray(jaf._auxes(jfilters._slab5(jg), w)[0].slab_row)
    got = np.zeros_like(slab_col)
    for i in range(nb):
        for k in range(W):
            if 0 <= i + k - w < nb:
                got[i, k] = slab_col[i + k - w, 2 * w - k]
    assert np.array_equal(got, want)
    assert np.array_equal(taf.row_layout(torch.from_numpy(slab_col),
                                         w).numpy(), want)


@pytest.mark.parametrize("with_s", [True, False])
def test_flash_apply_grads_match_jax(with_s):
    tg, jg, a1, a2, v, g = _operands(90, 50, 16, 2, 3, seed=7)
    w = tg.band_w
    jaux = jaf._auxes(jfilters._slab5(jg), w)[0]

    def jloss(a1, a2, v):
        y = jaf.flash_apply(a1, a2, v, jaux, w, 16, with_s, True, 0.2)
        return jnp.sum(y * jnp.asarray(g))
    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(jloss, argnums=(0, 1, 2))(*_j(a1, a2, v))
    ta = [t.requires_grad_() for t in _t(a1, a2, v)]
    y = taf.flash_apply(*ta, taf.band_auxes(tg)[0], w, 16, with_s)
    (y * torch.from_numpy(g)).sum().backward()
    for t, jw in zip(ta, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jw), **TOL)


def test_flash_apply_gradcheck_float64():
    """The plain FlashApply's backward against finite differences."""
    S = _graph(40, 20, 1, seed=8).astype(np.float64)
    tg = tgso.as_gso(S, mode="band", block_size=16, device="cpu")
    w = tg.band_w
    slab = taf.slab5(tg).double()
    aux = taf.make_aux(slab[0], taf.make_support(slab, w, torch.float64), w)
    Np = slab.shape[1] * 16
    gen = torch.Generator().manual_seed(9)
    a1, a2 = (torch.randn(1, Np, generator=gen, dtype=torch.float64)
              for _ in range(2))
    v = torch.randn(1, 2, Np, generator=gen, dtype=torch.float64)
    for with_s in (True, False):
        args = [t.clone().requires_grad_() for t in (a1, a2, v)]
        assert torch.autograd.gradcheck(
            lambda x1, x2, vv: taf.FlashApply.apply(x1, x2, vv, aux, w, 16,
                                                    with_s, 0.2), args)


def _entry(mod, kind, slab, w, x, a, W_p, h, b, **kw):
    if kind == "gat":
        return mod.graph_attention_band_flash(x, a, W_p, slab, w, **kw)
    if kind == "gcat":
        return mod.gat_lsigf_band_flash(h, x, a, W_p, slab, w, b, **kw)
    return mod.gat_evgf_band_flash(x, a, W_p, slab, w, b, **kw)


def _materialized(kind, slab, w, x, a, W_p, h, b):
    if kind == "gat":
        return tab.graph_attention_band(x, a, W_p, slab, w)
    if kind == "gcat":
        return tab.gat_lsigf_band(h, x, a, W_p, slab, w, b)
    return tab.gat_evgf_band(x, a, W_p, slab, w, b)


@pytest.mark.parametrize("kind", ["gat", "gcat", "evgf"])
def test_flash_entry_point_grads(kind):
    """Gradients in every input of the three flash entry points (ragged
    N; E = 2 for GAT) against jax.grad of the JAX ones and against autograd
    of the port's materialized band path."""
    N, P, F, G, B = 40, 2, 3, 2, 2
    E = 2 if kind == "gat" else 1
    S = _graph(N, 20, E, seed=10)
    tg = tgso.as_gso(S, mode="band", block_size=16, device="cpu")
    jg = jgso.as_gso(S, mode="band", block_size=16)
    rng = np.random.default_rng(11)
    hop = (2,) if kind == "evgf" else ()
    x = rng.standard_normal((B, G, N)).astype(np.float32)
    a = (rng.standard_normal((P,) + hop + (E, 2 * F)) * .3).astype(np.float32)
    W_p = (rng.standard_normal((P,) + hop + (E, F, G)) * .3).astype(
        np.float32)
    h = rng.random((E, 2)).astype(np.float32)
    b = rng.standard_normal((F, 1)).astype(np.float32)
    ct = rng.standard_normal((B, P, F, N)).astype(np.float32)
    inputs = (x, a, W_p, h, b)

    def jloss(*args):
        y = _entry(jaf, kind, jfilters._slab5(jg), jg.band_w, *args,
                   interpret=True)
        return jnp.sum(y * jnp.asarray(ct))
    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(jloss, argnums=tuple(range(5)))(*_j(*inputs))

    def grads(fn):
        ts = [t.requires_grad_() for t in _t(*inputs)]
        (fn(*ts) * torch.from_numpy(ct)).sum().backward()
        return [t.grad for t in ts]
    got = grads(lambda *ts: _entry(taf, kind, taf.slab5(tg), tg.band_w, *ts,
                                   auxes=taf.band_auxes(tg)))
    ref = grads(lambda *ts: _materialized(kind, taf.slab5(tg), tg.band_w,
                                          *ts))
    used = [0, 1, 2] + {"gat": [], "gcat": [3, 4], "evgf": [4]}[kind]
    for n in used:
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]),
                                   **TOL)
        np.testing.assert_allclose(got[n].numpy(), ref[n].numpy(), **TOL)


def test_bwd_call_checks_shapes():
    tg, _, a1, a2, v, g = _operands(90, 20, 16, 2, 3, seed=12)
    aux = taf.band_auxes(tg)[0]
    w = tg.band_w
    a1t, a2t, vt, gt = _t(a1, a2, v, g)
    mx, sm = taf.stats_plain(a1t, a2t, aux.mask_row, w=w, ibs=16)
    with pytest.raises(ValueError, match="g "):
        taf.bwd_call(a1t, a2t, vt, mx, sm, aux.slab_col, aux.mask_row,
                     gt[:, 1:], w=w, ibs=16)
    with pytest.raises(ValueError, match="mask_row"):
        taf.bwd_call(a1t, a2t, vt, mx, sm, aux.slab_col, aux.mask_row[1:],
                     gt, w=w, ibs=16)
