"""PyTorch port, parallel/: the BCSR partition of scattered graphs, the
rectangular BCSR shift (kernel 1 on one shard's column slice), the BCSR
and all-gather sharded shifts and ShardedGso's routing, held against the
JAX package on the CPU.

The port's mesh repeats the CPU device; the JAX side runs on the 8 virtual
CPU devices of tests/conftest.py, jitted (eager shard_map retraces at every
call). Partitions are compared exactly. Shifts, their input gradients and
lsigf at atol = rtol = 1e-4: the same f32 products summed in another order
(block order, the shards' gradients summed through the all-gather).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch
from jax.experimental.pallas import tpu as pltpu

from graph_neural_networks_torch import parallel as tpar
from graph_neural_networks_torch.ops import filters as tfilters
from graph_neural_networks_torch.ops import spmm as tspmm
from graph_neural_networks_tpu import parallel as jpar
from graph_neural_networks_tpu.ops import filters as jfilters
from graph_neural_networks_tpu.ops import spmm as jspmm

from tests.test_torch_parallel import (  # noqa: F401 (fixtures)
    _band_graph, _scrambled, local_path, meshes)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine: one intra-op thread
    keeps the many small torch ops here from oversubscribing its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(atol=1e-4, rtol=1e-4)
MESHES = [((1, 8), None), ((1, 8), "data"), ((2, 4), None),
          ((2, 4), "data")]


def _scattered(N, seed, density=0.03):
    """A symmetric scattered GSO (no band order: edges anywhere), as a
    dense numpy array."""
    rng = np.random.default_rng(seed)
    A = rng.random((N, N)) * (rng.random((N, N)) < density)
    A = A + A.T
    np.fill_diagonal(A, 0.0)
    return A / np.max(np.abs(np.linalg.eigvalsh(A)))


def _cycle(N=64):
    """Node 0 ~ node N-1: no partition of it in order is a ring."""
    ring = np.roll(np.eye(N), 1, axis=1)
    return ring + ring.T


@pytest.mark.parametrize("E", [1, 2])
@pytest.mark.parametrize("order", ["none", "rcm"])
def test_partition_bcsr_matches_jax(order, E):
    S = _scrambled(90, E, seed=7 + E)          # 90 nodes: 6 pad nodes
    got = tpar.partition_nodes_bcsr(S if E > 1 else S[0], 3, order=order,
                                    inner_block=8)
    want = jpar.partition_nodes_bcsr(S if E > 1 else S[0], 3, order=order,
                                     inner_block=8)
    for name in ("n_parts", "n_orig", "n_padded", "block_size", "inner_bs",
                 "n_edge_features", "shard_bytes"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.n_padded > got.n_orig
    for name in ("order", "blocks", "brow", "bcol", "blocks_t", "brow_t",
                 "bcol_t", "nnzb"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    for a, b in zip(got.S_csr, want.S_csr):
        assert (a != b).nnz == 0
    np.testing.assert_array_equal(got.S_perm, want.S_perm)
    # the pads keep both layouts sorted by block column (the kernel's
    # segment offsets come from searchsorted)
    assert (np.diff(got.bcol, axis=-1) >= 0).all()
    assert (np.diff(got.bcol_t, axis=-1) >= 0).all()
    assert (got.nnzb < got.bcol.shape[-1] * E).any()     # some shard padded
    x = np.random.default_rng(0).random((2, 90))
    np.testing.assert_array_equal(got.pad_signal(x), want.pad_signal(x))
    np.testing.assert_array_equal(got.unpad_signal(got.pad_signal(x)), x)


@pytest.mark.parametrize("p", [0, 3])
def test_bcsr_shift_rect_matches_jax(p):
    """One shard's rectangular shift (Np -> bs columns) and its input
    gradient (bs -> Np on the transposed layout), pads included, against
    the JAX custom VJP (Pallas kernel in interpret mode), the JAX plain
    gather/scatter and the dense column slice."""
    part = tpar.partition_nodes_bcsr(_scattered(200, 1), 4, inner_block=16)
    bs, ibs, Np = part.block_size, part.inner_bs, part.n_padded
    assert (bs, Np) == (64, 256)
    lay = [part.blocks[p, 0], part.brow[p, 0], part.bcol[p, 0],
           part.blocks_t[p, 0], part.brow_t[p, 0], part.bcol_t[p, 0]]
    rng = np.random.default_rng(p)
    x = rng.standard_normal((6, Np)).astype(np.float32)
    ct = rng.standard_normal((6, bs)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    y = tspmm.bcsr_shift_rect(xt, *map(torch.from_numpy, lay), bs, Np, ibs)
    (y * torch.from_numpy(ct)).sum().backward()

    def jloss(x):
        return jnp.sum(jspmm.bcsr_shift_rect(x, *lay, bs, Np, ibs) * ct)
    with pltpu.force_tpu_interpret_mode():
        want = jspmm.bcsr_shift_rect(jnp.asarray(x), *lay, bs, Np, ibs)
        dx_want = jax.grad(jloss)(jnp.asarray(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        y.detach().numpy(), np.asarray(jspmm.bcsr_gather_scatter(
            jnp.asarray(x), *lay[:3], bs, ibs)), **TOL)
    S_p = part.S_perm[0][:, p * bs:(p + 1) * bs]
    np.testing.assert_allclose(y.detach().numpy(), x @ S_p, **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_want), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), ct @ S_p.T, **TOL)


def _shift_pair(tshift_fn, jshift_fn, jmesh, x, ct):
    """(port y, port dx, JAX y, JAX dx) of <ct, shift(x)>."""
    xt = torch.from_numpy(x).requires_grad_()
    y = tshift_fn(xt)
    (y * torch.from_numpy(ct)).sum().backward()
    with jmesh:
        fn = jax.jit(jshift_fn)
        want = fn(jnp.asarray(x))
        dx = jax.jit(jax.grad(lambda v: jnp.sum(jshift_fn(v) * ct)))(
            jnp.asarray(x))
    return y.detach().numpy(), xt.grad.numpy(), np.asarray(want), \
        np.asarray(dx)


@pytest.mark.parametrize("shape,data_axis", MESHES)
def test_sharded_gshift_bcsr_matches_jax(meshes, shape, data_axis):
    tmesh, jmesh = meshes[shape]
    S = _scattered(200, 2)
    part_t = tpar.partition_nodes_bcsr(S, shape[1], inner_block=16)
    part_j = jpar.partition_nodes_bcsr(S, shape[1], inner_block=16)
    rng = np.random.default_rng(3)
    x = part_t.pad_signal(rng.standard_normal((2, 3, 1, 2, 200))).astype(
        np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    y, dx, y_j, dx_j = _shift_pair(
        tpar.sharded_gshift_bcsr(tmesh, part_t, data_axis=data_axis),
        jpar.sharded_gshift_bcsr(jmesh, part_j, data_axis=data_axis),
        jmesh, x, ct)
    np.testing.assert_allclose(y, y_j, **TOL)
    np.testing.assert_allclose(dx, dx_j, **TOL)
    Sp = part_t.S_perm
    np.testing.assert_allclose(y, np.einsum("...egn,enm->...egm", x, Sp),
                               **TOL)
    np.testing.assert_allclose(dx, np.einsum("...egm,enm->...egn", ct, Sp),
                               **TOL)


@pytest.mark.parametrize("shape,data_axis", MESHES)
def test_sharded_gshift_allgather_matches_jax(meshes, local_path, shape,
                                              data_axis):
    tmesh, jmesh = meshes[shape]
    part_t = tpar.partition_nodes(_cycle(), shape[1], order="none")
    part_j = jpar.partition_nodes(_cycle(), shape[1], order="none")
    assert not part_t.is_ring and part_t.w > part_t.nbl
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 1, 2, 64)).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    y, dx, y_j, dx_j = _shift_pair(
        tpar.sharded_gshift_allgather(tmesh, part_t, data_axis=data_axis),
        jpar.sharded_gshift_allgather(jmesh, part_j, data_axis=data_axis),
        jmesh, x, ct)
    np.testing.assert_allclose(y, y_j, **TOL)
    np.testing.assert_allclose(dx, dx_j, **TOL)
    np.testing.assert_allclose(
        y, np.einsum("...egn,enm->...egm", x, part_t.S_perm), **TOL)


ROUTINGS = {  # name: (partition builder, prefer_ring, uses_ring)
    "ring": (lambda m: m.partition_nodes(_band_graph(), 8), True, True),
    "allgather-ring": (lambda m: m.partition_nodes(_band_graph(), 8), False,
                       False),
    "allgather-cycle": (lambda m: m.partition_nodes(_cycle(), 8,
                                                    order="none"),
                        True, False),
    "bcsr": (lambda m: m.partition_nodes_bcsr(_scattered(64, 5), 8,
                                              inner_block=16), True, False),
}


@pytest.mark.parametrize("routing", list(ROUTINGS))
def test_lsigf_over_each_routing_matches_jax(meshes, local_path, routing):
    """lsigf (K = 3, E = 1) over a ShardedGso of each routing, forward and
    the gradients of the taps and the signal, against the JAX ShardedGso;
    its debug S is the partition's dense GSO."""
    tmesh, jmesh = meshes[(1, 8)]
    build, prefer_ring, uses_ring = ROUTINGS[routing]
    sg_t = tpar.ShardedGso(tmesh, build(tpar), prefer_ring=prefer_ring)
    sg_j = jpar.ShardedGso(jmesh, build(jpar), prefer_ring=prefer_ring)
    assert sg_t.uses_ring == sg_j.uses_ring == uses_ring
    np.testing.assert_array_equal(sg_t.S.numpy(), np.asarray(sg_j.S))
    rng = np.random.default_rng(6)
    h = rng.standard_normal((4, 1, 3, 2)).astype(np.float32)
    x = sg_t.pad_signal(rng.standard_normal((3, 2, 64))).astype(np.float32)
    ct = rng.standard_normal((3, 4, sg_t.n)).astype(np.float32)
    ht = torch.from_numpy(h).requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    y = tfilters.lsigf(ht, sg_t, xt)
    (y * torch.from_numpy(ct)).sum().backward()

    def jloss(h, x):
        return jnp.sum(jfilters.lsigf(h, sg_j, x) * ct)
    with jmesh:
        want = jax.jit(lambda h, x: jfilters.lsigf(h, sg_j, x))(
            jnp.asarray(h), jnp.asarray(x))
        dh, dx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
            jnp.asarray(h), jnp.asarray(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(dh), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx), **TOL)


def test_cuda_mesh_refuses_an_untileable_block_on_each_shift():
    """On a CUDA mesh the all-gather and BCSR shifts take their kernels
    (band_matmul, bcsr_matmul), and an inner block that is not a multiple
    of the column tile raises at construction, before anything is placed
    on the card."""
    mesh = tpar.make_mesh((1, 8), devices=[torch.device("cuda", 0)] * 8)
    band = tpar.partition_nodes(_cycle(), 8, order="none")
    bcsr = tpar.partition_nodes_bcsr(_scattered(64, 5), 8, inner_block=16)
    match = f"TILE_N={tspmm.TILE_N}, got inner_bs=8"
    with pytest.raises(ValueError, match="band_matmul kernel.*" + match):
        tpar.sharded_gshift_allgather(mesh, band)
    with pytest.raises(ValueError, match="bcsr_matmul kernel.*" + match):
        tpar.sharded_gshift_bcsr(mesh, bcsr)
    with pytest.raises(TypeError, match="BcsrPartition"):
        tpar.sharded_gshift_bcsr(mesh, band)


def test_scattered_graph_partitions_into_few_blocks():
    """The graph of chip_smoke.py's scattered_n4096_sharded, cut to N =
    512 with inner blocks of 16 (__graft_entry__.py's scattered-graph
    dry run): 3 * nb block pairs at 30% fill land in few blocks a shard,
    where the band slab of the same graph degenerates dense."""
    rng = np.random.default_rng(0)
    ibs, N = 16, 512
    nbk = N // ibs
    S = np.zeros((N, N), np.float32)
    for _ in range(3 * nbk):
        bi, bj = rng.integers(0, nbk, 2)
        blk = rng.random((ibs, ibs)) * (rng.random((ibs, ibs)) > .7)
        S[bi * ibs:(bi + 1) * ibs, bj * ibs:(bj + 1) * ibs] = blk
        S[bj * ibs:(bj + 1) * ibs, bi * ibs:(bi + 1) * ibs] = blk.T
    part = tpar.partition_nodes_bcsr(S, 4, inner_block=ibs)
    band = tpar.partition_nodes(scipy.sparse.csr_matrix(S), 4,
                                inner_block=ibs)
    assert part.nnzb.sum() <= 6 * nbk
    assert part.shard_bytes < band.slabs[0].nbytes
    assert not band.is_ring
