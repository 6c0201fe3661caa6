"""PyTorch port, sharded training: the flash backward of one shard
(ops/attention_flash.py ``bwd_ext_plain``, the plain version of kernel 12,
behind ``bwd_ext_call``), ``parallel.mesh.halo_fold``, the gradients of the
sharded flash schedule (parallel/attention.py), the ring-sharded
SelectionGNN's gradients and ``Trainer(mesh=...)``, held against the JAX
package on the CPU.

The port's meshes repeat the CPU device; the JAX side runs on the 8
virtual CPU devices of tests/conftest.py, jitted, its Pallas calls with
interpret=True passed in (never under pltpu.force_tpu_interpret_mode(),
whose simulated devices crashed test workers now and then). The JAX ext
backward reads S from its row-layout slab (``_row_slabs``), the port's from
its halo-extended column slab (``_ext_slabs``); the two layouts are
compared exactly. Every S is non-symmetric, so a swapped row/column
orientation fails.

Tolerances: the row layouts and halo_fold bit for bit (copies and one add
a column); everything else atol = rtol = 1e-4 (f32 softmax VJPs summed in
another order); loss trajectories rtol 1e-4, as the unsharded Trainer's
(tests/test_torch_training.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze
from jax import shard_map
from jax.sharding import PartitionSpec as P

from graph_neural_networks_torch import parallel as tpar
from graph_neural_networks_torch import training as ttrain
from graph_neural_networks_torch.models import architectures as tarch
from graph_neural_networks_torch.ops import attention_flash as taf
from graph_neural_networks_torch.parallel import attention as tsha
from graph_neural_networks_torch.parallel import mesh as tmesh
from graph_neural_networks_torch.parallel import shift as tshift
from graph_neural_networks_torch.utils.params import load_flax_params
from graph_neural_networks_tpu import data as jdata
from graph_neural_networks_tpu import parallel as jpar
from graph_neural_networks_tpu import training as jtrain
from graph_neural_networks_tpu.models import architectures as jarch
from graph_neural_networks_tpu.ops import attention_flash as jaf
from graph_neural_networks_tpu.parallel import attention as jsha
from graph_neural_networks_tpu.utils import graph as jgt

TOL = dict(atol=1e-4, rtol=1e-4)
TRAJ_RTOL = 1e-4
SLOPE = 0.2
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine: one intra-op thread
    keeps the many small torch ops here from oversubscribing its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meshes(shape):
    """(port mesh, JAX mesh) of `shape` over ('data', 'graph')."""
    n = int(np.prod(shape))
    assert jax.device_count() >= n
    return (tpar.make_mesh(shape, devices=[CPU] * n),
            jpar.make_mesh(shape, devices=jax.devices()[:n]))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, unfreeze(params))


def _band(N, half, E, seed, count=4):
    """E non-symmetric banded GSOs, nonzeros within `half` of the
    diagonal."""
    rng = np.random.default_rng(seed)
    S = np.zeros((E, N, N), np.float32)
    for e in range(E):
        ii = rng.integers(0, N, count * N)
        jj = ii + rng.integers(-half, half + 1, len(ii))
        ok = (jj >= 0) & (jj < N)
        S[e, ii[ok], jj[ok]] = rng.random(ok.sum())
    assert not np.allclose(S, np.swapaxes(S, 1, 2))
    return S


# ---------------------------------------------------------------------------
# One shard's flash backward (kernel 12's plain version)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ext_case():
    """A 4-shard partition (nbl = 4 inner blocks of 16, w = 2, 56 padded
    nodes in the last shard), global a1, a2, v and a cotangent g, zero on
    the padded nodes, and every shard's stats from stats_ext_plain."""
    rng = np.random.default_rng(0)
    N, Q, F = 200, 3, 5
    S = _band(N, 24, 1, seed=1)[0]
    part = tpar.partition_nodes(S, 4, order="none", inner_block=16)
    jpart = jpar.partition_nodes(S, 4, order="none", inner_block=16)
    assert (part.inner_bs, part.nbl, part.w) == (16, 4, 2)
    assert part.n_padded - part.n_orig == 56
    Np = part.n_padded

    def rand(*shape):
        t = np.zeros(shape + (Np,), np.float32)
        t[..., :N] = rng.standard_normal(shape + (N,))
        return t
    a1, a2, v, g = rand(Q), rand(Q), rand(Q, F), rand(Q, F)
    mc, mr = tsha._row_col_masks(part)
    w, ibs, bs = part.w, part.inner_bs, part.block_size
    stats = [[t.numpy() for t in taf.stats_ext_plain(
        *_t(_ext(a1, p, part), a2[:, p * bs:(p + 1) * bs], mr[p]), w=w,
        ibs=ibs)] for p in range(4)]
    return dict(part=part, jpart=jpart, a1=a1, a2=a2, v=v, g=g, mr=mr,
                stats=stats)


def _ext(t, p, part):
    """Shard p's block of the global t, halo-extended with zeros past the
    global ends."""
    bs, halo = part.block_size, part.halo
    pad = np.zeros(t.shape[:-1] + (halo,), t.dtype)
    tp = np.concatenate([pad, t, pad], axis=-1)
    return tp[..., p * bs:(p + 1) * bs + 2 * halo]


def _shard_bwd_operands(case, p):
    """Shard p's operands of the ext backward, in the port's order, the
    port's slab (halo-extended column layout) last."""
    part = case["part"]
    own = slice(p * part.block_size, (p + 1) * part.block_size)
    mx, sm = case["stats"][p]
    return ((_ext(case["a1"], p, part), case["a2"][:, own],
             case["v"][:, :, own], mx, sm),
            (case["mr"][p], _ext(case["g"], p, part)),
            tsha._ext_slabs(part)[p, 0])


@pytest.mark.parametrize("E", [1, 2])
def test_ext_slab_row_layout_is_jax_row_slabs(E):
    """The halo-extended column slab read in the row layout
    (ext_row_layout) is the JAX package's row-layout slab, the window of a
    shard's first and last w row blocks into its neighbours' columns
    included; its own blocks are the partition's own slab."""
    S = _band(200, 24, E, seed=2 + E)
    part = tpar.partition_nodes(S if E > 1 else S[0], 4, order="none",
                                inner_block=16)
    jpart = jpar.partition_nodes(S if E > 1 else S[0], 4, order="none",
                                 inner_block=16)
    w, nbl = part.w, part.nbl
    assert w == 2
    ext = tsha._ext_slabs(part)
    want = jsha._row_slabs(jpart)
    for p in range(4):
        np.testing.assert_array_equal(ext[p, :, w:w + nbl], part.slabs[p])
        for e in range(E):
            np.testing.assert_array_equal(
                taf.ext_row_layout(torch.from_numpy(ext[p, e]), w).numpy(),
                want[p, e])


@pytest.mark.parametrize("with_s", [True, False])
@pytest.mark.parametrize("p", [0, 1, 3], ids=["first", "interior", "last"])
def test_bwd_ext_plain_matches_jax(ext_case, p, with_s):
    """bwd_ext_plain of one shard against the JAX _bwd_ext_call (its own
    _row_slabs and _row_col_masks): da2, the da1 window partials in ext
    column coordinates, dv."""
    part, jpart = ext_case["part"], ext_case["jpart"]
    w, ibs = part.w, part.inner_bs
    head, (mrow, g_ext), slab_ext = _shard_bwd_operands(ext_case, p)
    got = taf.bwd_ext_plain(*_t(*head, slab_ext, mrow, g_ext), w=w, ibs=ibs,
                            with_s=with_s)
    jmr = jsha._row_col_masks(jpart)[1][p]
    bwd_j = jax.jit(jaf._bwd_ext_call, static_argnums=(8, 9, 10, 11, 12))
    want = bwd_j(*map(jnp.asarray, head), jnp.asarray(
        jsha._row_slabs(jpart)[p, 0]), jnp.asarray(jmr), jnp.asarray(g_ext),
        w, ibs, with_s, SLOPE, True)
    for name, gt, wt in zip(("da2", "da1p", "dv"), got, want):
        assert np.isfinite(gt.numpy()).all(), name
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt), err_msg=name,
                                   **TOL)


def _chunk_partition(kind):
    """A 4-shard partition at the CUDA kernel's 64-node granularity (nbl =
    2 inner blocks of 64): 'empty', nonzeros within 40 of the diagonal and
    two 130 apart (w = 2; most 64 x 64 tiles of the outer window blocks
    without support); 'full', every block within one of the diagonal
    filled (w = 1; no empty tile)."""
    rng = np.random.default_rng(5)
    N, ibs = 512, 64
    blk = np.arange(N) // ibs
    if kind == "full":
        S = (rng.random((N, N))
             * (np.abs(blk[:, None] - blk[None]) <= 1)).astype(np.float32)
    else:
        S = _band(N, 40, 1, seed=6)[0]
        S[[10, 300], [140, 170]] = 0.5
    return (tpar.partition_nodes(S, 4, order="none", inner_block=ibs),
            jpar.partition_nodes(S, 4, order="none", inner_block=ibs))


@pytest.mark.parametrize("p", [0, 1, 3], ids=["first", "interior", "last"])
@pytest.mark.parametrize("kind", ["empty", "full"])
def test_bwd_ext_plain_matches_jax_with_and_without_empty_chunks(kind, p):
    """bwd_ext_plain against the JAX _bwd_ext_call on a partition where
    the CUDA kernel skips sub-chunks without support (the halo blocks past
    the global ends among them) and on one where it skips none inside the
    matrix."""
    part, jpart = _chunk_partition(kind)
    w, ibs, bs, halo = part.w, part.inner_bs, part.block_size, part.halo
    assert (ibs, part.nbl, w) == (64, 2, 2 if kind == "empty" else 1)
    mc, mr = tsha._row_col_masks(part)
    occupied = mr[p].reshape(part.nbl, 2 * w + 1, -1).any(-1)
    inside = [[0 <= p * part.nbl + i + k - w < 4 * part.nbl
               for k in range(2 * w + 1)] for i in range(part.nbl)]
    empty_inside = int((~occupied & np.array(inside)).sum())
    assert empty_inside > 0 if kind == "empty" else empty_inside == 0
    rng = np.random.default_rng(12 + p)
    Q, F, Np = 2, 8, part.n_padded
    a1, a2 = (rng.standard_normal((Q, Np)).astype(np.float32)
              for _ in range(2))
    v, g = (rng.standard_normal((Q, F, Np)).astype(np.float32)
            for _ in range(2))
    own = slice(p * bs, (p + 1) * bs)
    a1e = _ext(a1, p, part)
    mx, sm = (t.numpy() for t in taf.stats_ext_plain(
        *_t(a1e, a2[:, own], mr[p]), w=w, ibs=ibs))
    head = (a1e, a2[:, own], v[:, :, own], mx, sm)
    g_ext = _ext(g, p, part)
    got = taf.bwd_ext_plain(*_t(*head, tsha._ext_slabs(part)[p, 0], mr[p],
                                g_ext), w=w, ibs=ibs)
    bwd_j = jax.jit(jaf._bwd_ext_call, static_argnums=(8, 9, 10, 11, 12))
    want = bwd_j(*map(jnp.asarray, head),
                 jnp.asarray(jsha._row_slabs(jpart)[p, 0]),
                 jnp.asarray(jsha._row_col_masks(jpart)[1][p]),
                 jnp.asarray(g_ext), w, ibs, True, SLOPE, True)
    assert halo == w * ibs
    for name, gt, wt in zip(("da2", "da1p", "dv"), got, want):
        assert np.isfinite(gt.numpy()).all(), name
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt), err_msg=name,
                                   **TOL)


def test_bwd_ext_call_takes_the_plain_version_on_the_cpu(ext_case):
    """On CPU tensors the wrapper returns bwd_ext_plain's result and counts
    no launch; it checks the halo-extended shapes first."""
    part = ext_case["part"]
    w, ibs = part.w, part.inner_bs
    head, (mrow, g_ext), slab_ext = _shard_bwd_operands(ext_case, 1)
    args = _t(*head, slab_ext, mrow, g_ext)
    taf.reset_launch_counts()
    got = taf.bwd_ext_call(*args, w=w, ibs=ibs)
    want = taf.bwd_ext_plain(*args, w=w, ibs=ibs)
    for gt, wt in zip(got, want):
        np.testing.assert_array_equal(gt.numpy(), wt.numpy())
    assert taf.bwd_ext_call.launches == 0
    bad = list(args)
    bad[-1] = bad[-1][..., 1:]
    with pytest.raises(ValueError, match="g_ext"):
        taf.bwd_ext_call(*bad, w=w, ibs=ibs)
    bad = list(args)
    bad[5] = bad[5][1:]
    with pytest.raises(ValueError, match="slab_col_ext"):
        taf.bwd_ext_call(*bad, w=w, ibs=ibs)


@pytest.mark.parametrize("with_s", [True, False])
def test_shard_backwards_assemble_the_global_backward(ext_case, with_s):
    """Every shard's bwd_ext_plain, its partials folded into ext columns
    (fold_ext_partials) and halo_fold-ed back, concatenated: the global
    bwd_plain with its fold_window_partials on the same operands."""
    part = ext_case["part"]
    w, ibs, halo = part.w, part.inner_bs, part.halo
    outs = [taf.bwd_ext_plain(*_t(*head, slab_ext, mrow, g_ext), w=w,
                              ibs=ibs, with_s=with_s)
            for head, (mrow, g_ext), slab_ext in (
                _shard_bwd_operands(ext_case, p) for p in range(4))]
    da1 = tmesh.halo_fold([taf.fold_ext_partials(o[1]) for o in outs], halo)
    got = [torch.cat(ts, dim=-1) for ts in
           (da1, [o[0] for o in outs], [o[2] for o in outs])]
    # the global operands: the same S, support, stats and signals,
    # unsharded (the shards' blocks in order)
    mx, sm = (np.concatenate([s[i] for s in ext_case["stats"]], axis=-1)
              for i in (0, 1))
    da2, da1p, dv = taf.bwd_plain(
        *_t(ext_case["a1"], ext_case["a2"], ext_case["v"], mx, sm,
            np.concatenate(list(part.slabs[:, 0])),
            np.concatenate(list(ext_case["mr"])), ext_case["g"]), w=w,
        ibs=ibs, with_s=with_s)
    want = (taf.fold_window_partials(da1p, w), da2, dv)
    for name, gt, wt in zip(("da1", "da2", "dv"), got, want):
        np.testing.assert_allclose(gt.numpy(), wt.numpy(), err_msg=name,
                                   **TOL)


# ---------------------------------------------------------------------------
# halo_fold
# ---------------------------------------------------------------------------

def _closure_fn(fn, name, depth=0):
    """The function called `name` among the closures of `fn` (the JAX
    halo_fold lives inside ShardedBandAttention._make_flash)."""
    if getattr(fn, "__name__", None) == name:
        return fn
    if depth > 6:
        return None
    kids = [c.cell_contents for c in getattr(fn, "__closure__", None) or ()]
    kids += [getattr(fn, a) for a in ("__wrapped__", "fun", "fwd", "bwd")
             if hasattr(fn, a)]
    for kid in kids:
        if callable(kid):
            found = _closure_fn(kid, name, depth + 1)
            if found is not None:
                return found
    return None


def test_halo_fold_matches_jax():
    """halo_fold of 4 shards' ext blocks against the JAX halo_fold under
    shard_map over the 'graph' axis of the (2, 4) CPU mesh."""
    _, jmesh = _meshes((2, 4))
    S = _band(96, 10, 1, seed=6)[0]
    jpart = jpar.partition_nodes(S, 4, order="none")
    halo, bs = jpart.halo, jpart.block_size
    assert halo > 0
    jattn = jsha.ShardedBandAttention(jmesh, jpart, local_flash=True)
    fold_j = _closure_fn(jattn._make_flash(True, False), "halo_fold")
    assert fold_j is not None
    x = np.random.default_rng(7).standard_normal(
        (3, 4 * (bs + 2 * halo))).astype(np.float32)
    with jmesh:
        want = jax.jit(shard_map(
            fold_j, mesh=jmesh, in_specs=P(None, "graph"),
            out_specs=P(None, "graph"), check_vma=False))(jnp.asarray(x))
    blocks = torch.from_numpy(x).chunk(4, dim=-1)
    got = torch.cat(tmesh.halo_fold(list(blocks), halo), dim=-1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,bs,halo", [(4, 6, 2), (3, 4, 4), (2, 5, 0)])
def test_halo_fold_is_the_transpose_of_halo_ext(n, bs, halo):
    """<halo_ext(x), y> = <x, halo_fold(y)> for every shard layout (a halo
    as wide as the block included)."""
    rng = np.random.default_rng(n + bs)
    x = [torch.from_numpy(rng.standard_normal((2, bs))) for _ in range(n)]
    y = [torch.from_numpy(rng.standard_normal((2, bs + 2 * halo)))
         for _ in range(n)]
    lhs = sum((a * b).sum() for a, b in zip(tmesh.halo_ext(x, halo), y))
    rhs = sum((a * b).sum() for a, b in zip(x, tmesh.halo_fold(y, halo)))
    np.testing.assert_allclose(lhs.item(), rhs.item(), rtol=1e-12)
    if halo == 0:
        assert tmesh.halo_fold(y, 0) is y


# ---------------------------------------------------------------------------
# Gradients of the sharded flash schedule
# ---------------------------------------------------------------------------

FUNCTIONALS = {
    "gat": (lambda x, a, W, s: tsha.sharded_graph_attention(x, a, W, s),
            lambda x, a, W, s: jsha.sharded_graph_attention(x, a, W, s),
            None),
    "gcat": (lambda x, a, W, s: tsha.sharded_gat_lsigf(
                 torch.tensor([[1.0, .5, .25]]), x, a, W, s),
             lambda x, a, W, s: jsha.sharded_gat_lsigf(
                 jnp.asarray([[1.0, .5, .25]]), x, a, W, s),
             None),
    "evgf": (lambda x, a, W, s: tsha.sharded_gat_evgf(x, a, W, s),
             lambda x, a, W, s: jsha.sharded_gat_evgf(x, a, W, s),
             2),
}


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)], ids=["1x4", "2x2"])
@pytest.mark.parametrize("kind", sorted(FUNCTIONALS))
def test_sharded_flash_grads_match_jax(kind, shape):
    """Gradients in x, a and W of a sharded GAT / GCAT (with_s False) /
    EV-attention layer through the flash schedule (here the plain versions
    of kernels 10-12) against JAX's ShardedBandAttention(local_flash=True)
    (its custom VJP, the Pallas calls interpreted), over 4 graph shards
    (1, 4) or 2 data x 2 graph shards (2, 2)."""
    t_fn, j_fn, K = FUNCTIONALS[kind]
    tm, jm = _meshes(shape)
    S = _band(96, 10, 1, seed=31)
    n_graph = shape[1]
    part = tpar.partition_nodes(S[0], n_graph, order="none")
    jpart = jpar.partition_nodes(S[0], n_graph, order="none")
    assert part.is_ring and part.w >= 1
    rng = np.random.default_rng(32)
    hop = () if K is None else (K,)
    B, Ph, G, F = 2, 2, 3, 3
    x = part.pad_signal(rng.standard_normal((B, G, 96)).astype(np.float32))
    a = (rng.standard_normal((Ph,) + hop + (1, 2 * F)) * .3).astype(
        np.float32)
    W_p = (rng.standard_normal((Ph,) + hop + (1, F, G)) * .3).astype(
        np.float32)
    ct = rng.standard_normal((B, Ph, F, part.n_padded)).astype(np.float32)
    jattn = jsha.ShardedBandAttention(jm, jpart, data_axis="data",
                                      local_flash=True)

    def loss_j(x, a, W):
        return jnp.sum(j_fn(x, a, W, jattn) * ct)

    with jm:
        want = jax.jit(jax.grad(loss_j, argnums=(0, 1, 2)))(
            *map(jnp.asarray, (x, a, W_p)))
    sattn = tsha.ShardedBandAttention(tm, part, data_axis="data",
                                      local_flash=True)
    assert sattn.use_flash and len(sattn.grid) == shape[0]
    leaves = [t.requires_grad_() for t in _t(x, a, W_p)]
    (t_fn(*leaves, sattn) * torch.from_numpy(ct)).sum().backward()
    for t, w, name in zip(leaves, want, ("x", "a", "W")):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   err_msg=name, **TOL)


# ---------------------------------------------------------------------------
# The ring-sharded SelectionGNN's gradients
# ---------------------------------------------------------------------------

def _band_graph(N=64, seed=0):
    """A path of clusters (tests/test_parallel.py)."""
    rng = np.random.default_rng(seed)
    W = np.zeros((N, N))
    for i in range(N - 1):
        W[i, i + 1] = W[i + 1, i] = 1.0
    for i in rng.integers(0, N - 4, 30):
        W[i, i + 3] = W[i + 3, i] = 0.5
    return W / np.max(np.abs(np.linalg.eigvalsh(W)))


@pytest.fixture(params=["window", "kernel"])
def local_path(request, monkeypatch):
    """The ring shift's shard-local contraction: the windowed einsum (the
    CPU's) or the square local band on spmm.BandShift with the halo
    corrections (the CUDA mesh's; here through band_matmul's plain
    version)."""
    use = request.param == "kernel"
    monkeypatch.setattr(tshift, "_uses_band_kernel", lambda mesh, part: use)
    return request.param


def test_ring_sharded_selection_gnn_grads_match_jax(local_path):
    """Parameter gradients of the CE loss through a SelectionGNN sharded 8
    ways (the ring shift and its backward) against the JAX sharded
    model's (tests/test_parallel.py's check) and the unsharded port's."""
    tm, jm = _meshes((1, 8))
    S = _band_graph()
    args = ([1, 4, 4], [3, 3], True, "relu", [64, 64], "NoPool", [1, 1],
            [3], S)
    rng = np.random.default_rng(40)
    x = rng.random((4, 1, 64)).astype(np.float32)
    y = rng.integers(0, 3, 4)
    ja = jarch.SelectionGNN(*args)
    params = ja.init(jax.random.PRNGKey(0))
    ja.shard(jm, 8)
    ctx, core = ja.ctx, ja.core

    def loss_j(p):
        logits = core.apply(p, jnp.asarray(x), ctx)[0]
        return jtrain.losses.cross_entropy_loss(logits, jnp.asarray(y))

    with jm:
        want = jax.jit(jax.grad(loss_j))(params)
    want = jax.tree_util.tree_map(np.asarray, unfreeze(want))
    grads = {}
    for sharded in (False, True):
        ta = tarch.SelectionGNN(*args, device="cpu")
        load_flax_params(ta, _numpy_tree(params))
        if sharded:
            ta.shard(tm, 8)
            assert ta.S.partition.w >= 1
        loss = ttrain.losses.cross_entropy_loss(ta(x), torch.from_numpy(y))
        grads[sharded] = torch.autograd.grad(loss, list(ta.parameters()))
    # the JAX gradients as the port's parameters: carried across like
    # weights, then read back in the parameters' order
    tj = tarch.SelectionGNN(*args, device="cpu")
    load_flax_params(tj, want)
    for g, g0, j in zip(grads[True], grads[False], tj.parameters()):
        np.testing.assert_allclose(g.numpy(), j.detach().numpy(), **TOL)
        np.testing.assert_allclose(g.numpy(), g0.numpy(), **TOL)


# ---------------------------------------------------------------------------
# Trainer(mesh=...)
# ---------------------------------------------------------------------------

def _source_loc(N, W, seed):
    G = jgt.Graph("adjacency", N, {"adjacencyMatrix": W})
    data = jdata.SourceLocalization(G, 48, 16, 16, [0, N // 2], tMax=4,
                                    rng=np.random.default_rng(seed))
    data.expandDims()
    return data


def _path_graph(N=32):
    """tests/test_training.py:test_mesh_hybrid_graph_sharded_trainer's
    graph: a path with second neighbours, banded."""
    W = np.zeros((N, N))
    for i in range(N - 1):
        W[i, i + 1] = W[i + 1, i] = 1.0
    for i in range(N - 2):
        W[i, i + 2] = W[i + 2, i] = 0.5
    return W


TRAINED = {
    # kind: (JAX class, port class, args before S, N)
    "selgnn": (jarch.SelectionGNN, tarch.SelectionGNN,
               ([1, 4], [3], True, "relu", [32], "NoPool", [1], [2]), 32),
    "gat": (jarch.GraphAttentionNetwork, tarch.GraphAttentionNetwork,
            ([1, 4], [2], "relu", [32], "NoPool", [1], [2], True), 32),
}


@pytest.mark.parametrize("kind,local", [
    ("selgnn", "window"), ("selgnn", "kernel"), ("gat", "windowed"),
    ("gat", "flash")])
def test_sharded_trainer_matches_jax(kind, local, tmp_path, monkeypatch):
    """A model sharded over the 'graph' axis of a (2, 4) mesh and trained
    by Trainer(mesh=..., meshAxis='data') (3 epochs of 3 batches of 16,
    validation every 2 steps) against the JAX sharded model trained by the
    JAX Trainer(mesh=...) from the same weights, after
    tests/test_training.py:test_mesh_hybrid_graph_sharded_trainer. The
    port's shard-local step: for SelectionGNN its two ring contractions,
    for the GAT the windowed path or the flash schedule (kernels 10-12's
    plain versions)."""
    cls_j, cls_t, args, N = TRAINED[kind]
    W = _path_graph(N)
    S = W / np.max(np.abs(np.linalg.eigvalsh(W)))
    if kind == "gat":   # a directed graph: swapped orientations differ
        S = S * (1 + np.triu(np.ones((N, N)), 1))
    data = _source_loc(N, W, seed=17)
    tm, jm = _meshes((2, 4))
    opt = {"name": "ADAM", "lr": 5e-3}
    ja = cls_j(*args, S)
    ja.shard(jm, 4, data_axis="data")
    jmodel = jtrain.Model(ja, jtrain.losses.cross_entropy_loss, opt,
                          jtrain.Trainer, jtrain.evaluate, name="j",
                          saveDir=str(tmp_path / "j"), seed=8)
    params = _numpy_tree(jmodel.params)
    kw = dict(nEpochs=3, batchSize=16, validationInterval=2)
    want = jmodel.train(data, mesh=jm, meshAxis="data", **kw)

    monkeypatch.setattr(tshift, "_uses_band_kernel",
                        lambda mesh, part: local == "kernel")
    ta = cls_t(*args, S, device="cpu")
    load_flax_params(ta, params)
    ta.shard(tm, 4, data_axis="data")
    assert ta.S.partition.is_ring and ta.S.partition.w >= 1
    if kind == "gat":
        ta.S._band_attention = tsha.ShardedBandAttention(
            tm, ta.S.partition, data_axis="data",
            local_flash=local == "flash")
    tmodel = ttrain.Model(ta, ttrain.losses.cross_entropy_loss, opt,
                          ttrain.Trainer, ttrain.evaluate, name="t",
                          saveDir=str(tmp_path / "t"))
    taf.reset_launch_counts()
    got = tmodel.train(data, mesh=tm, meshAxis="data", **kw)
    assert len(got["lossTrain"]) == 9
    np.testing.assert_allclose(got["lossTrain"], want["lossTrain"],
                               rtol=TRAJ_RTOL)
    np.testing.assert_allclose(got["costValid"], want["costValid"],
                               atol=1e-6)


def test_mesh_trainer_equals_the_single_device_trainer(tmp_path):
    """Trainer(mesh=...) of an unsharded model on a mesh of its own device
    takes the single-device steps: the same trajectory bit for bit, and
    meshAxis defaults to the mesh's first axis."""
    W = _path_graph()
    S = W / np.max(np.abs(np.linalg.eigvalsh(W)))
    data = _source_loc(32, W, seed=18)
    mesh = tpar.make_mesh((8,), ("data",), devices=[CPU] * 8)
    outs = []
    for m in (None, mesh):
        arch = tarch.SelectionGNN(*TRAINED["selgnn"][2], S, device="cpu",
                                  generator=torch.Generator().manual_seed(3))
        model = ttrain.Model(arch, ttrain.losses.cross_entropy_loss,
                             {"name": "ADAM", "lr": 5e-3}, ttrain.Trainer,
                             ttrain.evaluate, name="m",
                             saveDir=str(tmp_path / str(m is None)))
        trainer = ttrain.Trainer(model, data, 2, 16, mesh=m)
        assert trainer.meshAxis == (None if m is None else "data")
        outs.append(trainer.train())
    np.testing.assert_array_equal(outs[0]["lossTrain"], outs[1]["lossTrain"])
