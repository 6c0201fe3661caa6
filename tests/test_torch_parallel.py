"""PyTorch port, parallel/: the mesh, the partitioner, the ring graph shift
(both shard-local contractions), ShardedGso and SelectionGNN.shard(), held
against the JAX package on the CPU.

The port's mesh repeats the CPU device (8 graph or data x graph shards in
one process); the JAX side runs on the 8 virtual CPU devices that
tests/conftest.py sets up. The partition is compared exactly; shifts and
models at atol = rtol = 1e-4 (f32 sums in another order, and for the
models the MLP readout over F*N features).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch
from flax.core import unfreeze

from graph_neural_networks_torch import parallel as tpar
from graph_neural_networks_torch.models import architectures as tarch
from graph_neural_networks_torch.ops import filters as tfilters
from graph_neural_networks_torch.parallel import mesh as tmesh
from graph_neural_networks_torch.parallel import shift as tshift
from graph_neural_networks_torch.utils.params import load_flax_params
from graph_neural_networks_tpu import parallel as jpar
from graph_neural_networks_tpu.models import architectures as jarch
from graph_neural_networks_tpu.ops import filters as jfilters
from graph_neural_networks_tpu.ops import gso as jgso
from graph_neural_networks_tpu.parallel import shift as jshift


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine: one intra-op thread
    keeps the many small torch ops here from oversubscribing its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(atol=1e-4, rtol=1e-4)
CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(scope="module")
def meshes():
    """(port mesh, JAX mesh) pairs by shape."""
    assert jax.device_count() >= 8
    return {shape: (tpar.make_mesh(shape, devices=CPU8),
                    jpar.make_mesh(shape))
            for shape in ((1, 8), (2, 4))}


def _band_graph(N=64, seed=0):
    """A path of clusters, banded after RCM (tests/test_parallel.py)."""
    rng = np.random.default_rng(seed)
    W = np.zeros((N, N))
    for i in range(N - 1):
        W[i, i + 1] = W[i + 1, i] = 1.0
    for i in rng.integers(0, N - 4, 30):
        W[i, i + 3] = W[i + 3, i] = 0.5
    return W


def _scrambled(N, E, seed):
    """E non-symmetric sparse GSOs on a randomly permuted band (RCM has
    work to do), as scipy matrices."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(N)
    mats = []
    for _ in range(E):
        ii = rng.integers(0, N, 3 * N)
        jj = np.clip(ii + rng.integers(-6, 7, 3 * N), 0, N - 1)
        S = scipy.sparse.coo_matrix((rng.random(3 * N) + 0.1,
                                     (perm[ii], perm[jj])), shape=(N, N))
        mats.append(S.tocsr().tocoo())
    return mats


@pytest.mark.parametrize("E", [1, 2])
@pytest.mark.parametrize("order", ["none", "rcm"])
def test_partition_matches_jax(order, E):
    S = _scrambled(90, E, seed=3 + E)
    got = tpar.partition_nodes(S if E > 1 else S[0], 3, order=order,
                               inner_block=16)
    want = jpar.partition_nodes(S if E > 1 else S[0], 3, order=order,
                                inner_block=16)
    for name in ("n_parts", "n_orig", "n_padded", "block_size", "inner_bs",
                 "nbl", "w", "bandwidth", "is_ring", "halo",
                 "n_edge_features"):
        assert getattr(got, name) == getattr(want, name), name
    np.testing.assert_array_equal(got.order, want.order)
    np.testing.assert_array_equal(got.slabs, want.slabs)
    assert len(got.needs) == len(want.needs)
    for a, b in zip(got.needs, want.needs):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got.S_csr, want.S_csr):
        assert (a != b).nnz == 0
    x = np.random.default_rng(0).random((2, 90))
    np.testing.assert_array_equal(got.pad_signal(x), want.pad_signal(x))
    np.testing.assert_array_equal(got.unpad_signal(got.pad_signal(x)), x)


def test_make_mesh_repeats_devices(monkeypatch):
    mesh = tpar.make_mesh((2, 4), devices=CPU8)
    assert mesh.shape["data"] == 2 and mesh.shape["graph"] == 4
    assert mesh.home == torch.device("cpu") and mesh.size == 8
    assert mesh.grid("graph") == [[torch.device("cpu")] * 4]
    assert len(mesh.grid("graph", "data")) == 2
    # the grid is (data, graph) whatever the mesh's axis order
    gd = tpar.make_mesh((4, 2), ("graph", "data"), devices=CPU8)
    assert [len(r) for r in gd.grid("graph", "data")] == [4, 4]
    assert tpar.make_mesh(devices=CPU8[:3]).shape == {"data": 3, "graph": 1}
    with pytest.raises(ValueError, match="needs 6 devices"):
        tpar.make_mesh((2, 3), devices=CPU8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpar.make_mesh()


def test_halo_exchange_zero_fills_the_ends():
    shards = [torch.arange(4.) + 10 * p for p in range(3)]
    got = tmesh.halo_ext(shards, 2)
    np.testing.assert_array_equal(got[0].numpy(), [0, 0, 0, 1, 2, 3, 10, 11])
    np.testing.assert_array_equal(got[1].numpy(),
                                  [2, 3, 10, 11, 12, 13, 20, 21])
    np.testing.assert_array_equal(got[2].numpy(),
                                  [12, 13, 20, 21, 22, 23, 0, 0])
    assert tmesh.halo_ext(shards, 0) is shards


@pytest.fixture(params=["window", "kernel"])
def local_path(request, monkeypatch):
    """The ring shift's shard-local contraction: the windowed einsum (the
    CPU's) or the square local band on spmm.BandShift with the halo
    corrections (the CUDA mesh's; here through band_matmul's plain
    version)."""
    use = request.param == "kernel"
    monkeypatch.setattr(tshift, "_uses_band_kernel", lambda mesh, part: use)
    return request.param


@pytest.mark.parametrize("shape,data_axis", [((1, 8), None),
                                             ((2, 4), "data")])
def test_ring_shift_matches_jax(meshes, local_path, shape, data_axis):
    tmesh_, jmesh = meshes[shape]
    n_parts = shape[1]
    part_j = jpar.partition_nodes(_band_graph(), n_parts)
    part_t = tpar.partition_nodes(_band_graph(), n_parts)
    assert part_t.is_ring and part_t.w >= 1
    x = np.random.default_rng(1).random((2, 3, 1, 2, 64)).astype(np.float32)
    xp = part_t.pad_signal(x)
    with jmesh:
        want = np.asarray(jpar.sharded_gshift_ring(
            jmesh, part_j, data_axis=data_axis)(jnp.asarray(xp)))
    got = tpar.sharded_gshift_ring(tmesh_, part_t, data_axis=data_axis)(
        torch.from_numpy(xp))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(
        got.numpy(), np.einsum("...egn,enm->...egm", xp, part_t.S_perm),
        **TOL)


def test_local_contractions_match_jax():
    """Both shard-local contractions, forward and input gradient, against
    the JAX windowed contraction on a wide band (w >= 1, ibs = 128)."""
    N = 1024
    rng = np.random.default_rng(13)
    rows = np.repeat(np.arange(N), 3)
    cols = np.clip(rows + rng.integers(-100, 101, size=3 * N), 0, N - 1)
    A = scipy.sparse.coo_matrix((rng.random(3 * N), (rows, cols)),
                                shape=(N, N))
    part = tpar.partition_nodes(A, 2, order="none")
    assert part.inner_bs == 128 and part.w >= 1
    w, ibs, nbl, halo = part.w, part.inner_bs, part.nbl, part.halo
    x_ext = rng.random((2, 1, 2, (nbl + 2 * w) * ibs)).astype(np.float32)
    ct = rng.random((2, 1, 2, nbl * ibs)).astype(np.float32)
    want, vjp = jax.vjp(lambda xe: jshift._band_contract(
        xe, jnp.asarray(part.slabs[0])), jnp.asarray(x_ext))
    (dx_want,) = vjp(jnp.asarray(ct))
    s_sq, s_sq_t, lo, hi = (torch.from_numpy(t[0])
                            for t in tshift._sq_slabs(part))
    slab = torch.from_numpy(part.slabs[0])
    for name, fn in (
            ("window", lambda xe: tshift._window_local_contract(
                xe[..., halo:-halo], xe[..., :halo], xe[..., -halo:], slab,
                w, ibs, nbl)),
            ("kernel", lambda xe: tshift._kernel_local_contract(
                xe[..., halo:-halo].contiguous(), xe[..., :halo],
                xe[..., -halo:], s_sq, s_sq_t, lo, hi, w, ibs, nbl))):
        xt = torch.from_numpy(x_ext).requires_grad_()
        got = fn(xt)
        got.backward(torch.from_numpy(ct))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   err_msg=name, **TOL)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_want),
                                   err_msg=name, **TOL)


def test_sharded_gso_lsigf_matches_jax(meshes):
    tmesh_, jmesh = meshes[(1, 8)]
    part_j = jpar.partition_nodes(_band_graph(), 8)
    sg_t = tpar.ShardedGso(tmesh_, tpar.partition_nodes(_band_graph(), 8))
    assert sg_t.n == 64 and sg_t.n_edge_features == 1
    rng = np.random.default_rng(2)
    h = rng.random((4, 1, 3, 2)).astype(np.float32)
    x = sg_t.pad_signal(rng.random((2, 2, 64)).astype(np.float32))
    with jmesh:
        want = np.asarray(jfilters.lsigf(jnp.asarray(h),
                                         jpar.ShardedGso(jmesh, part_j),
                                         jnp.asarray(x)))
    got = tfilters.lsigf(torch.from_numpy(h), sg_t, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jfilters.lsigf(
            jnp.asarray(h), jgso.as_gso(part_j.S_perm), jnp.asarray(x))),
        **TOL)


def test_sharded_gso_refuses_what_is_not_ported():
    """What a ShardedGso still refuses, now that the all-gather and BCSR
    shifts are ported (tests/test_torch_sharded_bcsr.py): attention over a
    partition that is not a ring (as in JAX), a BCSR inner block the CUDA
    kernel cannot tile, a partition of an unknown type."""
    mesh = tpar.make_mesh((1, 8), devices=CPU8)
    N = 64
    ring = np.roll(np.eye(N), 1, axis=1)
    ring = ring + ring.T                     # a cycle: node 0 ~ node 63
    part = tpar.partition_nodes(ring, 8, order="none")
    assert not part.is_ring
    sg_cycle = tpar.ShardedGso(mesh, part)
    assert not sg_cycle.uses_ring
    with pytest.raises(ValueError, match="needs a ring GraphPartition"):
        sg_cycle.band_attention
    bcsr = tpar.partition_nodes_bcsr(ring, 8, inner_block=16)
    with pytest.raises(ValueError, match="needs a ring GraphPartition"):
        tpar.ShardedGso(mesh, bcsr).band_attention
    cuda = tpar.make_mesh((1, 8), devices=[torch.device("cuda", 0)] * 8)
    with pytest.raises(ValueError, match="bcsr_matmul kernel needs"):
        tpar.ShardedGso(cuda, bcsr)
    with pytest.raises(TypeError, match="GraphPartition or a BcsrPartition"):
        tpar.ShardedGso(mesh, object())
    sg = tpar.ShardedGso(mesh, tpar.partition_nodes(_band_graph(), 8))
    assert sg.to("cpu") is sg
    with pytest.raises(ValueError, match="lives on its mesh"):
        sg.to(torch.device("cuda", 1))


def test_ring_shift_without_halo(local_path):
    """A graph with no edge across inner blocks (w = 0, no halo): both
    local contractions, the kernel's with its exchange skipped, against
    the dense shift."""
    rng = np.random.default_rng(4)
    S = np.kron(np.eye(4), rng.random((16, 16)) * (rng.random((16, 16)) < .3))
    part = tpar.partition_nodes(S, 4, order="none")
    assert part.w == 0 and part.halo == 0
    x = rng.random((2, 1, 3, 64)).astype(np.float32)
    got = tpar.sharded_gshift_ring(
        tpar.make_mesh((1, 4), devices=CPU8[:4]), part)(torch.from_numpy(x))
    np.testing.assert_allclose(
        got.numpy(), np.einsum("...egn,enm->...egm", x, part.S_perm), **TOL)


def test_cuda_mesh_refuses_an_untileable_block():
    """On a CUDA mesh the local contraction is the band_matmul kernel, and
    an inner block that is not a multiple of its column tile raises at
    construction (before anything is placed on the card) instead of
    running the einsum there."""
    mesh = tpar.make_mesh((1, 8), devices=[torch.device("cuda", 0)] * 8)
    part = tpar.partition_nodes(_band_graph(), 8)
    assert part.inner_bs % tshift.spmm.TILE_N
    match = f"TILE_N={tshift.spmm.TILE_N}, got inner_bs={part.inner_bs}"
    with pytest.raises(ValueError, match=match):
        tpar.sharded_gshift_ring(mesh, part)
    with pytest.raises(ValueError, match=match):
        tpar.ShardedGso(mesh, part)


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, unfreeze(params))


@pytest.mark.parametrize("order", ["none", "rcm"])
def test_selection_gnn_shard_matches_jax(meshes, local_path, order):
    tmesh_, jmesh = meshes[(1, 8)]
    W = _band_graph()
    S = W / np.max(np.abs(np.linalg.eigvalsh(W)))
    args = ([1, 4, 4], [3, 3], True, "relu", [64, 64], "NoPool", [1, 1], [3],
            S)
    ja = jarch.SelectionGNN(*args)
    params = ja.init(jax.random.PRNGKey(0))
    ta = tarch.SelectionGNN(*args, device="cpu")
    load_flax_params(ta, _numpy_tree(params))
    x = np.random.default_rng(3).random((3, 1, 64)).astype(np.float32)
    want_unsharded = np.asarray(ja.apply(params, x))
    ja.shard(jmesh, 8, order=order)
    ta.shard(tmesh_, 8, order=order)
    with jmesh:
        want = np.asarray(ja.apply(params, x))
    got = ta(x).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)
    if order == "none":
        np.testing.assert_allclose(got, want_unsharded, **TOL)
    assert list(ta.order) == [int(i) for i in ja.order]


def test_shard_rcm_refuses_selection_pooling():
    """order='rcm' would reorder position-semantic selection pooling; the
    model is left as it was."""
    W = _band_graph()
    ta = tarch.SelectionGNN([1, 4, 4], [2, 2], True, "relu", [32, 16],
                            "MaxPoolLocal", [2, 2], [3], W, device="cpu")
    S_before = ta.S
    with pytest.raises(ValueError, match="identity pooling"):
        ta.shard(tpar.make_mesh((1, 8), devices=CPU8), 8, order="rcm")
    assert ta.S is S_before
