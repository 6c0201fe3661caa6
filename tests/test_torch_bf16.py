"""PyTorch port, bf16 serving (ROADMAP item 2): the bf16 plain versions of
kernels 1-3 and 7-8 against the JAX Pallas kernels in bf16 (interpret
mode), the bf16 InferenceEngine against JAX's InferenceEngine(...,
dtype=jnp.bfloat16), and what shows that the path ran in bf16: the ops'
io dtypes, the caller's model left f32, the GSO's cast (its cached band
structure cast, not rebuilt).

Tolerances, with the bf16 ulp of a value v taken as 2^(floor(log2|v|) - 7)
(8 significant bits):
  * kernels 1, 3 and 8 (one rounding of an f32 accumulator, as JAX): 2
    ulps of the larger of the two values, per element;
  * kernel 2, the register: tap k (k >= 1) within k + 1 ulps of the tap's
    largest magnitude: each tap is rounded before the next reads it, so
    an ulp at one tap moves the next;
  * kernel 7 (f32 stats from bf16 scores): 1e-5 relative;
  * an engine: 1e-2 of the largest |y| (the test prints the largest
    difference it saw): bf16 rounds the activations and GEMM outputs of
    every layer, at other points in the two frameworks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from graph_neural_networks_torch import kernels
from graph_neural_networks_torch import serving as tserving
from graph_neural_networks_torch.models import architectures as tarch
from graph_neural_networks_torch.ops import attention_flash as taf
from graph_neural_networks_torch.ops import gso as tgso
from graph_neural_networks_torch.ops import spmm as tspmm
from graph_neural_networks_torch.utils.params import load_flax_params
from graph_neural_networks_tpu import serving as jserving
from graph_neural_networks_tpu.models import architectures as jarch
from graph_neural_networks_tpu.ops import attention_flash as jaf
from graph_neural_networks_tpu.ops import filters as jfilters
from graph_neural_networks_tpu.ops import spmm as jspmm
from tests.test_torch_attention import _kernel_operands
from tests.test_torch_serving import (B, N, _banded, _db_pair, _db_request,
                                      _graph, _selection, _tree, _x)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine: one intra-op thread
    keeps the many small torch ops here from oversubscribing its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ENGINE_TOL = 1e-2


def _bf16(a) -> torch.Tensor:
    """A numpy array rounded to bf16, as a torch tensor."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16()


def _j(t: torch.Tensor):
    """A torch bf16 tensor as a JAX bf16 array (the same values)."""
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.double().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32), np.float64)


def _ulps(got, want, scale=None) -> np.ndarray:
    """|got - want| in bf16 ulps of the larger magnitude (or of `scale`)."""
    got, want = _f64(got), _f64(want)
    if scale is None:
        scale = np.maximum(np.abs(got), np.abs(want))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(scale, 1e-30))) - 7)
    return np.abs(got - want) / ulp


# ---------------------------------------------------------------------------
# Kernels 1-3: the graph shift
# ---------------------------------------------------------------------------

def _band_case(seed, n, half, bs=16, R=11):
    rng = np.random.default_rng(seed)
    S = np.zeros((n, n))
    for i in range(n):
        js = np.clip(i + rng.integers(-half, half + 1, 4), 0, n - 1)
        S[i, js] = rng.standard_normal(4)
    s_band, w = tspmm.dense_to_band(S, bs)
    return _bf16(rng.standard_normal((R, n))), _bf16(s_band), w, S


@pytest.mark.parametrize("n,half", [(96, 20), (90, 40)], ids=["w2", "ragged"])
def test_band_matmul_bf16_matches_jax(n, half):
    x, s_band, w, _ = _band_case(1, n, half)
    want = jspmm.band_matmul(_j(x), _j(s_band), n_cols=n, w=w, block_size=16,
                             row_tile=8, interpret=True)
    got = tspmm.band_matmul(x, s_band, n_cols=n, w=w, block_size=16)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert _ulps(got, want).max() <= 2


@pytest.mark.parametrize("n,half,K", [(96, 20, 4), (90, 40, 3)],
                         ids=["w2", "ragged"])
def test_band_shift_register_bf16_matches_jax(n, half, K):
    x, s_band, w, _ = _band_case(2, n, half, R=12)
    want = jspmm.band_shift_register(_j(x), _j(s_band), n_taps=K, n_cols=n,
                                     w=w, block_size=16, row_tile=8,
                                     interpret=True)
    got = tspmm.band_shift_register(x, s_band, n_taps=K, n_cols=n, w=w,
                                    block_size=16)
    assert got.dtype == torch.bfloat16 and got.shape == (K, 12, n)
    assert torch.equal(got[0], x)
    for k in range(1, K):
        scale = np.abs(_f64(want[k])).max()
        assert _ulps(got[k], want[k], scale).max() <= k + 1, k
    # each tap is the previous one shifted and rounded
    for k in range(1, K):
        assert torch.equal(got[k], tspmm.band_matmul_plain(
            got[k - 1], s_band, n_cols=n, w=w, block_size=16))


@pytest.mark.parametrize("n_in,n_cols", [(96, 96), (40, 64)],
                         ids=["square", "rect"])
def test_bcsr_matmul_bf16_matches_jax(n_in, n_cols):
    rng = np.random.default_rng(n_in + n_cols)
    bs = 16
    nb_in, nb_out = -(-n_in // bs), -(-n_cols // bs)
    pattern = [(r, c) for c in range(nb_out) for r in range(nb_in)
               if rng.random() < 0.6 or r == c % nb_in]
    rows = np.array([p[0] for p in pattern], np.int32)
    cols = np.array([p[1] for p in pattern], np.int32)
    blocks = _bf16(rng.standard_normal((len(pattern), bs, bs)))
    x = _bf16(rng.standard_normal((10, n_in)))
    want = jspmm.bcsr_matmul(_j(x), _j(blocks), jnp.asarray(rows),
                             jnp.asarray(cols), n_cols=n_cols, block_size=bs,
                             row_tile=8, interpret=True)
    got = tspmm.bcsr_matmul(x, blocks, torch.from_numpy(rows),
                            torch.from_numpy(cols), n_cols=n_cols,
                            block_size=bs)
    assert got.dtype == torch.bfloat16 and got.shape == (10, n_cols)
    assert _ulps(got, want).max() <= 2


def test_kernel_wrappers_take_one_io_dtype():
    """The CUDA path's input checks: f32 or bf16 io, S in x's dtype; a
    dtype the kernels lack raises, never casts."""
    x = torch.zeros(2, 16, dtype=torch.float16)
    with pytest.raises(TypeError, match="f32 or bf16"):
        kernels.io_dtype("band_matmul", x)
    with pytest.raises(TypeError, match="s_band must be torch.bfloat16"):
        tspmm._check_kernel_inputs("band_matmul", 64,
                                   torch.zeros(2, 64, dtype=torch.bfloat16),
                                   s_band=torch.zeros(1, 64, 64))


# ---------------------------------------------------------------------------
# Kernels 7-8: flash attention's stats and apply
# ---------------------------------------------------------------------------

def _attn_operands(seed, N_=96, half=20):
    tg, jg, a1, a2, v = _kernel_operands(seed, N=N_, half=half)
    w = tg.band_w
    taux = taf.band_auxes(tg.to(dtype=torch.bfloat16))[0]
    jaux = jaf._auxes(jfilters._slab5(jg).astype(jnp.bfloat16), w)[0]
    a1, a2 = _bf16(a1), _bf16(a2)
    with pltpu.force_tpu_interpret_mode():
        jstats = jaf._stats_call(_j(a1), _j(a2), jaux.mask_row, w, 16, 0.2,
                                 True)
    return w, taux, jaux, a1, a2, _bf16(v), jstats


@pytest.fixture(scope="module")
def attn_cases():
    """The operands of each case with the JAX kernel's stats (computed
    once: the interpreted stats call takes seconds)."""
    return {"w2": _attn_operands(2), "ragged": _attn_operands(1, 90, 40)}


@pytest.mark.parametrize("case", ["w2", "ragged"])
def test_stats_bf16_matches_jax(attn_cases, case):
    w, taux, _, a1, a2, _, (jmx, jsm) = attn_cases[case]
    mx, sm = taf.stats_call(a1, a2, taux.mask_row, w=w, ibs=16)
    assert mx.dtype == sm.dtype == torch.float32
    for got, want in ((mx, jmx), (sm, jsm)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(
            got.shape), rtol=1e-5, atol=0)


@pytest.mark.parametrize("with_s", [True, False])
def test_apply_bf16_matches_jax(attn_cases, with_s):
    w, taux, jaux, a1, a2, v, (jmx, jsm) = attn_cases["w2"]
    with pltpu.force_tpu_interpret_mode():
        want = jaf._apply_call(_j(a1), _j(a2), _j(v), jmx, jsm, jaux.slab_col,
                               jaux.mask_col, w, 16, with_s, 0.2, True)
    mx, sm = (torch.from_numpy(np.array(t).reshape(a1.shape))
              for t in (jmx, jsm))
    got = taf.apply_call(a1, a2, v, mx, sm, taux.slab_col, taux.mask_col, w=w,
                         ibs=16, with_s=with_s)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert _ulps(got, want).max() <= 2


# ---------------------------------------------------------------------------
# The bf16 engine
# ---------------------------------------------------------------------------

def _gat_pair():
    args = ([2, 4, 4], [2, 2], "relu", [N, N], "NoPool", [1, 1], [3], True,
            _banded(1))
    ja = jarch.GraphAttentionNetwork(*args, attentionMode="band")
    params = jax.jit(ja.init)(jax.random.PRNGKey(2))   # eager init: ~8 s
    ta = tarch.GraphAttentionNetwork(*args, attentionMode="band", device="cpu")
    load_flax_params(ta, _tree(params))
    return ja, params, ta


# the kernels' ops a bf16 forward of each model calls
ENGINE_OPS = {"select_dense": (), "select_band": ("band_shift_register",),
              "select_bcsr": ("bcsr_matmul",),
              "gat_band": ("stats_call", "apply_call"), "local_db_ell": ()}


@pytest.mark.parametrize("name", list(ENGINE_OPS))
def test_bf16_engine_matches_jax(name):
    if name.startswith("select"):
        mode = name.split("_")[1]
        ja, params, ta = _selection(mode, None if mode == "dense"
                                    else _banded())
        args = (_x(9),)
    elif name == "gat_band":
        ja, params, ta = _gat_pair()
        args = (_x(10),)
    else:
        ja, params, ta = _db_pair("local")
        x, jS, tS = _db_request(11, "ell")
        args = (x, tS)
    jargs = (args[0], jS) if name == "local_db_ell" else args
    with pltpu.force_tpu_interpret_mode():
        jeng = jserving.InferenceEngine(ja, params, jargs,
                                        dtype=jnp.bfloat16)
        want = np.asarray(jeng(*jargs))
    eng = tserving.InferenceEngine(ta, B, device="cpu", dtype=torch.bfloat16)
    kernels.OP_CALLS.clear()
    got = eng(*args)
    assert got.dtype == torch.float32
    err = np.abs(got.numpy() - want).max()
    print(f"{name}: largest |bf16 port - bf16 JAX| {err:.3e}, "
          f"max|y| {np.abs(want).max():.3e}")
    assert err <= ENGINE_TOL * np.abs(want).max()
    # every kernel op of the forward ran in bf16, and only they ran
    assert set(kernels.OP_CALLS) == {(op, torch.bfloat16)
                                     for op in ENGINE_OPS[name]}
    # the caller's model is still f32
    assert all(p.dtype == torch.float32 for p in ta.parameters())
    S = getattr(ta, "S", None)
    if isinstance(S, tgso.Gso):
        assert S.S.dtype == torch.float32
        assert eng._served.S.S.dtype == torch.bfloat16
    # the f32 engine on the same model is unchanged by the bf16 one
    f32 = tserving.InferenceEngine(ta, B, device="cpu")(*args)
    assert np.abs(f32.numpy() - got.numpy()).max() <= (
        ENGINE_TOL * np.abs(f32.numpy()).max())


def test_gso_cast_keeps_structure_and_cached_band():
    """Gso.to(dtype=) casts the float tensors, keeps the int32 structure,
    and casts the cached attention band structure instead of rebuilding
    it (the same entry lists)."""
    S = _banded()
    g = tgso.as_gso(S, mode="band", block_size=64, device="cpu")
    auxes = taf.band_auxes(g)
    gb = g.to(dtype=torch.bfloat16)
    assert gb is not g and gb.s_band.dtype == torch.bfloat16
    assert g.s_band.dtype == torch.float32
    assert taf.band_auxes(gb)[0].sup_entries is auxes[0].sup_entries
    assert taf.band_auxes(gb)[0].mask_row.dtype == torch.bfloat16
    assert g.to(dtype=torch.float32) is g and gb.to(dtype=torch.bfloat16) is gb
    c = tgso.as_gso(S, mode="bcsr", block_size=64, device="cpu")
    cb = c.to(dtype=torch.bfloat16)
    assert cb.blocks.dtype == cb.blocks_t.dtype == torch.bfloat16
    assert cb.col_start is c.col_start and cb.block_row is c.block_row


def test_sharded_bf16_raises_naming_2_1():
    """Named when bf16 serving of a sharded model was refused (ROADMAP item
    2.1); now its parity: the SelectionGNN sharded over a (1, 2) mesh
    serves in bf16 (its ShardedGso's bf16 twin, the ring shift in bf16)
    within ENGINE_TOL of JAX's bf16 engine on its sharded model and of the
    port's unsharded bf16 engine. The GRNN assertion, once a refusal
    naming item 2.2, now serves a GRNN in bf16: f32 outputs within
    ENGINE_TOL of JAX's bf16 engine on the same weights and z0."""
    from graph_neural_networks_torch import parallel
    from graph_neural_networks_tpu import parallel as jpar
    ja, params, ta = _selection("band", _banded())
    x = _x(12)
    unsharded = tserving.InferenceEngine(ta, B, device="cpu",
                                         dtype=torch.bfloat16)(x).numpy()
    mesh = parallel.make_mesh((1, 2), devices=[torch.device("cpu")] * 2)
    ta.shard(mesh, 2)
    jmesh = jpar.make_mesh((1, 2), devices=jax.devices()[:2])
    ja.shard(jmesh, 2)
    with jmesh:
        want = np.asarray(jserving.InferenceEngine(
            ja, params, (x,), dtype=jnp.bfloat16)(x))
    got = tserving.InferenceEngine(ta, B, device="cpu",
                                   dtype=torch.bfloat16)(x).numpy()
    assert ta.S.dtype == torch.float32
    for ref in (want, unsharded):
        assert np.abs(got - ref).max() <= ENGINE_TOL * np.abs(ref).max()
    grnn_args = (2, 3, 4, [3, 2], True, "tanh", "relu", "identity", [3],
                 _graph())
    jgrnn = jarch.GraphRecurrentNN(*grnn_args)
    F0, _ = jgrnn._input_shape
    jparams = jax.jit(jgrnn.core.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, F0, N)),
        jnp.zeros((1, jgrnn.H, N)), jgrnn.ctx)
    grnn = tarch.GraphRecurrentNN(*grnn_args, device="cpu")
    load_flax_params(grnn, _tree(jparams))
    xg = np.random.default_rng(13).standard_normal((B, 3, 2, N)).astype(
        np.float32)
    y16 = tserving.InferenceEngine(grnn, B, device="cpu",
                                   dtype=torch.bfloat16)(xg)
    z0 = grnn.draw_z0(B, N).numpy()
    want = np.asarray(jserving.InferenceEngine(
        jgrnn, jparams, (xg, z0), dtype=jnp.bfloat16)(xg, z0))
    assert y16.dtype == torch.float32 and y16.shape == (B, 3, 3, N)
    assert np.abs(y16.numpy() - want).max() <= ENGINE_TOL * np.abs(
        want).max()
    assert {p.dtype for p in grnn.parameters()} == {torch.float32}
