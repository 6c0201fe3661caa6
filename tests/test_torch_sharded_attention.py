"""PyTorch port, node-sharded band attention: parallel/attention.py (the
flash schedule and the windowed path), the ext-layout plain versions of
kernels 10-11 (ops/attention_flash.py) and GraphAttentionNetwork.shard()
with the InferenceEngine, held against the JAX package on the CPU.

The port's mesh repeats the CPU device; the JAX side runs on the 8
virtual CPU devices of tests/conftest.py, its Pallas ext calls with
interpret=True (a single shard's calls under
pltpu.force_tpu_interpret_mode(), the sharded operator's as the JAX
package's own tests run them). Every S is
non-symmetric, so a swapped row/column orientation fails. The support
masks are compared exactly; everything else at atol = rtol = 1e-4: f32
softmax scores and aggregations summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze
from jax.experimental.pallas import tpu as pltpu

from graph_neural_networks_torch import parallel as tpar
from graph_neural_networks_torch.models import architectures as tarch
from graph_neural_networks_torch.ops import attention_flash as taf
from graph_neural_networks_torch.ops import filters as tfilters
from graph_neural_networks_torch.parallel import attention as tsha
from graph_neural_networks_torch.serving import InferenceEngine
from graph_neural_networks_torch.utils.params import load_flax_params
from graph_neural_networks_tpu import parallel as jpar
from graph_neural_networks_tpu.models import architectures as jarch
from graph_neural_networks_tpu.ops import attention_flash as jaf
from graph_neural_networks_tpu.parallel import attention as jsha


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine: one intra-op thread
    keeps the many small torch ops here from oversubscribing its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(atol=1e-4, rtol=1e-4)
SLOPE = 0.2


@pytest.fixture(scope="module")
def meshes():
    """The (2, 4) data x graph mesh: (port, JAX)."""
    assert jax.device_count() >= 8
    return (tpar.make_mesh((2, 4), devices=[torch.device("cpu")] * 8),
            jpar.make_mesh((2, 4), ("data", "graph")))


def _graph(N=96, bw=10, E=1, seed=0):
    """E non-symmetric banded GSOs: a directed path plus random edges
    within bw of the diagonal."""
    rng = np.random.default_rng(seed)
    S = np.zeros((E, N, N), np.float32)
    for e in range(E):
        for i in range(N - 1):
            S[e, i, i + 1] = rng.random() + 0.1
        for i in rng.integers(0, N - bw, 60):
            S[e, i + rng.integers(1, bw), i] = rng.random()
    assert not np.allclose(S, np.swapaxes(S, 1, 2))
    return S


def _setup(E=1, P=2, F=3, G=2, B=2, K=None, seed=0):
    """Partition (4 graph shards, order none), padded x, a, W_p (numpy)."""
    S = _graph(E=E, seed=seed)
    part = tpar.partition_nodes(S, 4, order="none")
    assert part.is_ring and part.w >= 1
    rng = np.random.default_rng(seed + 1)
    hop = () if K is None else (K,)
    x = part.pad_signal(rng.standard_normal((B, G, 96)).astype(np.float32))
    a = (rng.standard_normal((P,) + hop + (E, 2 * F)) * .3).astype(
        np.float32)
    W_p = (rng.standard_normal((P,) + hop + (E, F, G)) * .3).astype(
        np.float32)
    return S, part, x, a, W_p


def _jpart(S):
    return jpar.partition_nodes(S, 4, order="none")


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("E", [1, 2])
@pytest.mark.parametrize("order", ["none", "rcm"])
def test_row_col_masks_match_jax(order, E):
    S = _graph(N=90, E=E, seed=5 + E)
    perm = np.random.default_rng(E).permutation(90)
    S = S[:, perm][:, :, perm]             # RCM has work to do
    got = tsha._row_col_masks(tpar.partition_nodes(S, 3, order=order,
                                                   inner_block=16))
    want = jsha._row_col_masks(jpar.partition_nodes(S, 3, order=order,
                                                    inner_block=16))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _ext_operands(seed=0):
    """A 4-shard partition with nbl = 4 inner blocks of 16, w = 2 and 56
    padded nodes in the last shard, and global (Q, Np) projections and
    (Q, F, Np) signals, zero on the padded nodes."""
    rng = np.random.default_rng(seed)
    N, Q, F = 200, 3, 5
    S = np.zeros((N, N), np.float32)
    ii = rng.integers(0, N, 4 * N)
    jj = ii + rng.integers(-24, 25, 4 * N)
    ok = (jj >= 0) & (jj < N)
    S[ii[ok], jj[ok]] = rng.random(ok.sum())
    part = tpar.partition_nodes(S, 4, order="none", inner_block=16)
    assert (part.inner_bs, part.nbl, part.w) == (16, 4, 2)
    assert part.n_padded - part.n_orig == 56
    Np = part.n_padded

    def rand(*shape):
        t = np.zeros(shape[:-1] + (Np,), np.float32)
        t[..., :N] = rng.standard_normal(shape[:-1] + (N,))
        return t
    return part, rand(Q, N), rand(Q, N), rand(Q, F, N)


def _ext(t, p, part):
    """Shard p's block of the global t, halo-extended with zeros past the
    global ends."""
    bs, halo = part.block_size, part.halo
    pad = np.zeros(t.shape[:-1] + (halo,), t.dtype)
    tp = np.concatenate([pad, t, pad], axis=-1)
    return tp[..., p * bs:(p + 1) * bs + 2 * halo]


@pytest.fixture(scope="module")
def ext_case():
    """The operands of _ext_operands, every shard's stats from
    stats_ext_plain, and the JAX _stats_ext_call's (the schedule's first
    step on every shard)."""
    part, a1, a2, v = _ext_operands()
    mc, mr = tsha._row_col_masks(part)
    w, ibs, bs = part.w, part.inner_bs, part.block_size
    stats_j = jax.jit(jaf._stats_ext_call, static_argnums=(3, 4, 5, 6))
    Q = a1.shape[0]
    got, want = [], []
    for s in range(4):
        o = slice(s * bs, (s + 1) * bs)
        ops = (_ext(a1, s, part), a2[:, o], mr[s])
        got.append([t.numpy() for t in taf.stats_ext_plain(
            *_t(*ops), w=w, ibs=ibs)])
        with pltpu.force_tpu_interpret_mode():
            want.append([np.asarray(t).reshape(Q, bs) for t in stats_j(
                *map(jnp.asarray, ops), w, ibs, SLOPE, True)])
    return part, a1, a2, v, mc, got, want


@pytest.mark.parametrize("p", [0, 1, 3], ids=["first", "interior", "last"])
def test_stats_ext_plain_matches_jax(ext_case, p):
    """stats_ext_plain of one shard against the JAX _stats_ext_call,
    padded rows included."""
    part, *_, got, want = ext_case
    for g, w in zip(got[p], want[p]):
        np.testing.assert_allclose(g, w, **TOL)
    if p == 3:   # a padded row sums W*ibs ones, as the JAX ext kernel does
        np.testing.assert_allclose(got[p][1][:, -1],
                                   (2 * part.w + 1) * part.inner_bs)


@pytest.mark.parametrize("p", [0, 1, 3], ids=["first", "interior", "last"])
def test_stats_ext_plain_rows_without_support_match_jax(ext_case, p):
    """Rows without support in a shard's first and last w row blocks
    (whose windows reach a neighbour's halo, or zeros past the global
    ends) and in the middle: stats_ext_plain against the JAX
    _stats_ext_call, rowmax -1e12 and rowsum W*ibs on those rows (as
    stats_plain gives the same rows of the unsharded graph)."""
    part, a1, a2, *_ = ext_case
    _, mr = tsha._row_col_masks(part)
    w, ibs, bs = part.w, part.inner_bs, part.block_size
    rows = [0, ibs + 1, bs // 2, bs - ibs - 1, bs - 1]
    mask = mr[p].copy()
    for r in rows:
        mask[r // ibs, :, r % ibs, :] = 0
    ops = (_ext(a1, p, part), a2[:, p * bs:(p + 1) * bs], mask)
    got = [t.numpy() for t in taf.stats_ext_plain(*_t(*ops), w=w, ibs=ibs)]
    stats_j = jax.jit(jaf._stats_ext_call, static_argnums=(3, 4, 5, 6))
    with pltpu.force_tpu_interpret_mode():
        want = [np.asarray(t).reshape(a1.shape[0], bs) for t in stats_j(
            *map(jnp.asarray, ops), w, ibs, SLOPE, True)]
    for g, wt in zip(got, want):
        np.testing.assert_allclose(g, wt, **TOL)
    for mx, sm in (got, want):
        assert (mx[:, rows] == np.float32(-1e12)).all()
        assert (sm[:, rows] == (2 * w + 1) * ibs).all()


@pytest.mark.parametrize("with_s", [True, False])
@pytest.mark.parametrize("p", [0, 1, 3], ids=["first", "interior", "last"])
def test_apply_ext_plain_matches_jax(ext_case, p, with_s):
    """apply_ext_plain of one shard (its rows and stats halo-extended from
    the neighbours', as the schedule exchanges them) against the JAX
    _apply_ext_call."""
    part, a1, a2, v, mc, stats, _ = ext_case
    w, ibs, bs = part.w, part.inner_bs, part.block_size
    own = slice(p * bs, (p + 1) * bs)
    mx, sm = (np.concatenate([s[i] for s in stats], axis=-1)
              for i in (0, 1))
    ops = (a1[:, own], _ext(a2, p, part), _ext(v, p, part), _ext(mx, p, part),
           _ext(sm, p, part), part.slabs[p, 0], mc[p])
    got = taf.apply_ext_plain(*_t(*ops), w=w, ibs=ibs, with_s=with_s)
    apply_j = jax.jit(jaf._apply_ext_call,
                      static_argnums=(7, 8, 9, 10, 11))
    with pltpu.force_tpu_interpret_mode():
        want = apply_j(*map(jnp.asarray, ops), w, ibs, with_s, SLOPE, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert np.isfinite(got.numpy()).all()
    # the CPU wrappers take the plain versions and count no launch
    taf.reset_launch_counts()
    np.testing.assert_array_equal(
        taf.apply_ext_call(*_t(*ops), w=w, ibs=ibs, with_s=with_s).numpy(),
        got.numpy())
    assert taf.apply_ext_call.launches == 0


def _ext_case_of(kind, seed=3):
    """A 4-shard partition (inner blocks of 16) of a graph with support
    inside the diagonal inner blocks only (kind "w0": w = 0, no halo) or of
    a w = 2 band with an empty window tile and an empty sub-tile in shard
    1 (kind "holes"); (Q, Np) projections and (Q, F, Np) signals zero on
    the padded nodes, every shard's stats from stats_ext_plain."""
    rng = np.random.default_rng(seed)
    N, Q, F = 200, 3, 5
    S = np.zeros((N, N), np.float32)
    ii = rng.integers(0, N, 4 * N)
    jj = (ii // 16 * 16 + rng.integers(0, 16, 4 * N) if kind == "w0"
          else ii + rng.integers(-24, 25, 4 * N))
    ok = (jj >= 0) & (jj < N)
    S[ii[ok], jj[ok]] = rng.random(ok.sum())
    if kind == "holes":   # shard 1 owns columns 64..128
        S[64:80, 96:112] = 0     # own column block 2, window block k = 0
        S[88:96, 64:72] = 0      # own column block 0, a sub-tile of k = 3
    part = tpar.partition_nodes(S, 4, order="none", inner_block=16)
    assert part.w == (0 if kind == "w0" else 2)
    Np = part.n_padded

    def rand(*shape):
        t = np.zeros(shape[:-1] + (Np,), np.float32)
        t[..., :N] = rng.standard_normal(shape[:-1] + (N,))
        return t
    a1, a2, v = rand(Q, N), rand(Q, N), rand(Q, F, N)
    mc, mr = tsha._row_col_masks(part)
    bs = part.block_size
    stats = [[t.numpy() for t in taf.stats_ext_plain(
        *_t(_ext(a1, s, part), a2[:, s * bs:(s + 1) * bs], mr[s]),
        w=part.w, ibs=part.inner_bs)] for s in range(4)]
    return part, a1, a2, v, mc, stats


def _apply_ext_ops(part, a1, a2, v, mc, stats, p):
    bs = part.block_size
    mx, sm = (np.concatenate([s[i] for s in stats], axis=-1)
              for i in (0, 1))
    return (a1[:, p * bs:(p + 1) * bs], _ext(a2, p, part), _ext(v, p, part),
            _ext(mx, p, part), _ext(sm, p, part), part.slabs[p, 0], mc[p])


@pytest.mark.parametrize("with_s", [True, False])
@pytest.mark.parametrize("kind", ["w0", "holes"])
def test_apply_ext_plain_reciprocal_form_matches_jax(kind, with_s):
    """apply_ext_plain in the kernel's form (one reciprocal of rowsum a
    row) against the JAX _apply_ext_call, which divides, at w = 0 and on
    a shard with an empty window tile and sub-tile."""
    part, *rest = _ext_case_of(kind)
    p = 1
    ops = _apply_ext_ops(part, *rest, p)
    if kind == "holes":
        mcol = ops[-1]
        assert not mcol[2, 0].any() and not mcol[0, 3, 8:, :8].any()
    got = taf.apply_ext_plain(*_t(*ops), w=part.w, ibs=part.inner_bs,
                              with_s=with_s)
    apply_j = jax.jit(jaf._apply_ext_call,
                      static_argnums=(7, 8, 9, 10, 11))
    with pltpu.force_tpu_interpret_mode():
        want = apply_j(*map(jnp.asarray, ops), part.w, part.inner_bs,
                       with_s, SLOPE, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert np.isfinite(got.numpy()).all()


def test_apply_ext_plain_fully_masked_halo_rows(ext_case):
    """The first shard's left halo lies past the global start: its rows
    have zero stats (rowsum 0, so the guarded reciprocal is 1e30) and no
    support. alpha there is exactly 0: no NaN, and whatever v holds in
    those rows never reaches y."""
    part, a1, a2, v, mc, stats, _ = ext_case
    halo = part.halo
    ops = list(_apply_ext_ops(part, a1, a2, v, mc, stats, 0))
    assert halo > 0 and not ops[4][:, :halo].any()    # sm_ext
    assert not ops[3][:, :halo].any()                 # mx_ext
    got = taf.apply_ext_plain(*_t(*ops), w=part.w, ibs=part.inner_bs)
    assert np.isfinite(got.numpy()).all()
    v_ext = ops[2].copy()
    v_ext[..., :halo] = np.random.default_rng(0).standard_normal(
        v_ext[..., :halo].shape) * 1e3
    ops[2] = v_ext
    np.testing.assert_array_equal(
        taf.apply_ext_plain(*_t(*ops), w=part.w, ibs=part.inner_bs).numpy(),
        got.numpy())


def test_ext_wrappers_check_shapes():
    part, a1, a2, v = _ext_operands()
    mc, mr = (torch.from_numpy(t[1]) for t in tsha._row_col_masks(part))
    w, ibs, bs = part.w, part.inner_bs, part.block_size
    a1e, a2o = _t(_ext(a1, 1, part), a2[:, bs:2 * bs])
    with pytest.raises(ValueError, match="halo-extended"):
        taf.stats_ext_call(a1e[:, 1:], a2o, mr, w=w, ibs=ibs)
    with pytest.raises(ValueError, match="mask_row"):
        taf.stats_ext_call(a1e, a2o, mr[1:], w=w, ibs=ibs)
    mx, sm = taf.stats_ext_call(a1e, a2o, mr, w=w, ibs=ibs)
    a2e, ve = _t(_ext(a2, 1, part), _ext(v, 1, part))
    with pytest.raises(ValueError, match="v_ext"):
        taf.apply_ext_call(a2o, a2e, ve[..., 1:], a2e, a2e,
                           torch.from_numpy(part.slabs[1, 0]), mc, w=w,
                           ibs=ibs)


@pytest.mark.parametrize("with_s", [True, False])
@pytest.mark.parametrize("flash", [True, False], ids=["flash", "windowed"])
def test_sharded_apply_matches_jax(meshes, flash, with_s):
    """ShardedBandAttention.apply on the (2, 4) mesh, Q split over
    'data': the port's flash schedule (its plain ext versions) and its
    windowed path against the JAX operator with the same local_flash."""
    tmesh, jmesh = meshes
    S, part, *_ = _setup(seed=21)
    rng = np.random.default_rng(4)
    Q, F, Np = 4, 3, part.n_padded
    a1, a2 = (rng.standard_normal((Q, Np)).astype(np.float32)
              for _ in range(2))
    v = rng.standard_normal((Q, F, Np)).astype(np.float32)
    sattn = tsha.ShardedBandAttention(tmesh, part, data_axis="data",
                                      local_flash=flash)
    assert sattn.use_flash == flash and len(sattn.grid) == 2
    got = sattn.apply(*_t(a1, a2, v), with_s=with_s)
    jattn = jsha.ShardedBandAttention(jmesh, _jpart(S), data_axis="data",
                                      local_flash=flash)
    # the JAX operator passes interpret=True itself on a CPU mesh, as its
    # own tests run it; the TPU interpret mode, which simulates the 8
    # devices in threads that wait at barriers, crashed a test worker now
    # and then
    with jmesh:
        want = jax.jit(lambda *t: jattn.apply(*t, with_s=with_s))(
            *map(jnp.asarray, (a1, a2, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


FUNCTIONALS = {
    "gat": (lambda x, a, W, s: tsha.sharded_graph_attention(x, a, W, s),
            lambda x, a, W, s: jsha.sharded_graph_attention(x, a, W, s)),
    "gcat": (lambda x, a, W, s: tsha.sharded_gat_lsigf(
                 torch.tensor([[1.0, .5, .25]] * W.shape[1]), x, a, W, s),
             lambda x, a, W, s: jsha.sharded_gat_lsigf(
                 jnp.asarray([[1.0, .5, .25]] * W.shape[1]), x, a, W, s)),
    "evgf": (lambda x, a, W, s: tsha.sharded_gat_evgf(x, a, W, s),
             lambda x, a, W, s: jsha.sharded_gat_evgf(x, a, W, s)),
}


@pytest.mark.parametrize("E", [1, 2])
@pytest.mark.parametrize("kind", sorted(FUNCTIONALS))
def test_sharded_functionals_match_jax(meshes, kind, E):
    tmesh, jmesh = meshes
    S, part, x, a, W_p = _setup(E=E, seed=8 + E,
                                K=2 if kind == "evgf" else None)
    t_fn, j_fn = FUNCTIONALS[kind]
    got = t_fn(*_t(x, a, W_p), tsha.ShardedBandAttention(
        tmesh, part, data_axis="data"))
    jattn = jsha.ShardedBandAttention(jmesh, _jpart(S), data_axis="data")
    with jmesh:
        want = jax.jit(lambda *t: j_fn(*t, jattn))(
            *map(jnp.asarray, (x, a, W_p)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_filters_route_sharded_gso(meshes):
    """The attention functionals with a ShardedGso run the sharded path."""
    tmesh, _ = meshes
    S, part, x, a, W_p = _setup(seed=11)
    sgso = tpar.ShardedGso(tmesh, part, data_axis="data")
    xt, at, Wt = _t(x, a, W_p)
    want = tsha.sharded_graph_attention(xt, at, Wt, tsha.ShardedBandAttention(
        tmesh, part, data_axis="data", local_flash=True))
    got = tfilters.graph_attention(xt, at, Wt, sgso)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    dense = tfilters.graph_attention(xt, at, Wt, torch.from_numpy(S))
    np.testing.assert_allclose(got.numpy(), dense.numpy(), **TOL)


def test_windowed_grads_match_jax(meshes):
    """Gradients of the windowed path (autograd through the halo copies)
    against JAX's autodiff through its shard_map; the flash schedule's
    (its backward: bwd_ext_call per shard, here the plain version) equal
    them."""
    tmesh, jmesh = meshes
    S, part, x, a, W_p = _setup(seed=22)
    jattn = jsha.ShardedBandAttention(jmesh, _jpart(S))

    def loss_j(x, a, W):
        return jnp.sum(jsha.sharded_graph_attention(x, a, W, jattn) ** 2)

    with jmesh:
        want = jax.jit(jax.grad(loss_j, argnums=(0, 1, 2)))(
            *map(jnp.asarray, (x, a, W_p)))
    leaves = [t.requires_grad_() for t in _t(x, a, W_p)]
    sattn = tsha.ShardedBandAttention(tmesh, part, local_flash=False)
    tsha.sharded_graph_attention(*leaves, sattn).square().sum().backward()
    for t, w, name in zip(leaves, want, ("x", "a", "W")):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   err_msg=name, **TOL)
    flash = tsha.ShardedBandAttention(tmesh, part, local_flash=True)
    grads = torch.autograd.grad(
        tsha.sharded_graph_attention(*leaves, flash).square().sum(), leaves)
    for g, t, name in zip(grads, leaves, ("x", "a", "W")):
        np.testing.assert_allclose(g.numpy(), t.grad.numpy(), err_msg=name,
                                   **TOL)


def test_local_flash_routing():
    """local_flash=None takes the windowed path on a CPU mesh; True runs
    the flash schedule there on any inner block (the plain versions)."""
    mesh = tpar.make_mesh((1, 4), devices=[torch.device("cpu")] * 4)
    _, part, *_ = _setup()
    assert part.inner_bs % taf.TILE_N
    assert not tsha.ShardedBandAttention(mesh, part).use_flash
    assert tsha.ShardedBandAttention(mesh, part, local_flash=True).use_flash
    with pytest.raises(ValueError, match="devices for 4 graph shards"):
        tsha.ShardedBandAttention(
            tpar.make_mesh((1, 2), devices=[torch.device("cpu")] * 2), part)


@pytest.mark.parametrize("local_flash", [None, True])
def test_cuda_mesh_refuses_an_untileable_block(local_flash):
    """On a CUDA mesh the flash schedule is the default, and an inner
    block that is not a multiple of the kernels' column tile raises at
    construction instead of serving the plain versions on the card. The
    mesh only names the card: the check runs before anything is placed
    on it."""
    mesh = tpar.make_mesh((1, 4), devices=[torch.device("cuda", 0)] * 4)
    _, part, *_ = _setup()
    assert part.inner_bs % taf.TILE_N
    with pytest.raises(ValueError, match=f"TILE_N={taf.TILE_N}, got "
                       f"inner_bs={part.inner_bs}"):
        tsha.ShardedBandAttention(mesh, part, local_flash=local_flash)


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, unfreeze(params))


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "windowed"])
def test_gat_shard_matches_jax(meshes, flash):
    """GraphAttentionNetwork.shard() with the JAX model's weights against
    the JAX sharded model, and the InferenceEngine on it (a ragged
    request padded to the engine's batch)."""
    tmesh, jmesh = meshes
    S = _graph(N=96, seed=13)[0]
    S = S / np.abs(np.linalg.eigvals(S)).max()
    args = ([2, 4, 4], [2, 2], "relu", [96, 96], "NoPool", [1, 1], [3],
            True, S)
    ja = jarch.GraphAttentionNetwork(*args)
    params = ja.init(jax.random.PRNGKey(1))
    ta = tarch.GraphAttentionNetwork(*args, device="cpu")
    load_flax_params(ta, _numpy_tree(params))
    x = np.random.default_rng(3).standard_normal((4, 2, 96)).astype(
        np.float32)
    want_unsharded = np.asarray(ja.apply(params, x))
    ja.shard(jmesh, 4, data_axis="data")
    with jmesh:
        want = np.asarray(ja.apply(params, x))
    ta.shard(tmesh, 4, data_axis="data")
    ta.S._band_attention = tsha.ShardedBandAttention(
        tmesh, ta.S.partition, data_axis="data", local_flash=flash)
    np.testing.assert_allclose(ta(x).detach().numpy(), want, **TOL)
    np.testing.assert_allclose(want, want_unsharded, **TOL)
    eng = InferenceEngine(ta, 4, device="cpu")
    assert eng.arch.S is ta.S
    np.testing.assert_allclose(eng(x[:3]).numpy(), want[:3], **TOL)
