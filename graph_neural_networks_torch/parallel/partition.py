"""Host-side sparse graph partitioner for node-sharded execution.

The port's copy of the JAX package's ``parallel/partition.py``
(``_to_coo_list``, ``GraphPartition``, ``_rcm_order``,
``partition_nodes``, ``BcsrPartition``, ``partition_nodes_bcsr``): host
numpy/scipy code, the same layouts bit for bit. The dense ``E x N x N``
GSO is never materialized:

  1. Order nodes with reverse Cuthill-McKee (bandwidth minimization ->
     halo minimization), or keep their order (``order="none"``).
  2. Split the ordered node set into P contiguous shard blocks
     (``block_size`` nodes each), and tile each shard into ``nbl`` inner
     blocks of ``inner_bs`` nodes.
  3. Store, per shard, only the band of S feeding that shard's output
     columns: ``slabs[p, e, j, k]`` is the (inner_bs x inner_bs) block
     ``S[block j+k-w, block j]`` in shard p -- memory O(N * bandwidth).

The ring shift and the sharded attention (``parallel.shift``,
``parallel.attention``) then need only a halo of ``w * inner_bs``
boundary nodes from each neighbour shard (``is_ring``: ``w <= nbl``);
the all-gather shift takes any band. A scattered graph (RCM bandwidth ~
N, where the band slab degenerates dense) takes the BCSR partition
(``partition_nodes_bcsr``): each shard keeps the nonzero blocks of its
column slice of S.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np
import scipy.sparse
import scipy.sparse.csgraph

from graph_neural_networks_torch.ops import spmm

ZERO_TOL = 1e-9

# refuse to densify a partitioned GSO above this N (the whole point of the
# sparse path); S_perm is a small-graph test/debug convenience only
_DENSE_OK_N = 16384


def _to_coo_list(S) -> List[scipy.sparse.coo_matrix]:
    """Normalize input to a list of scipy COO matrices (one per edge
    feature E). Accepts scipy sparse, a list of them, or dense
    (N,N)/(E,N,N) numpy arrays."""
    if scipy.sparse.issparse(S):
        return [S.tocoo()]
    if isinstance(S, (list, tuple)):
        if not all(scipy.sparse.issparse(m) for m in S):
            raise TypeError("a list GSO must hold scipy sparse matrices")
        return [m.tocoo() for m in S]
    S = np.asarray(S)
    if S.ndim == 2:
        S = S[None]
    if not (S.ndim == 3 and S.shape[1] == S.shape[2]):
        raise ValueError(f"GSO must be (N, N) or (E, N, N), got {S.shape}")
    return [scipy.sparse.coo_matrix(S[e]) for e in range(S.shape[0])]


@dataclass
class GraphPartition:
    """Node partition of an N-node graph into P contiguous shard blocks,
    with the GSO stored as sharded band slabs (see module docstring)."""
    n_parts: int
    n_orig: int                    # original N
    n_padded: int                  # N padded to n_parts * block_size
    block_size: int                # nodes per shard
    order: np.ndarray              # (n_orig,) permutation applied to nodes
    inner_bs: int                  # inner tile size (nodes)
    nbl: int                       # inner blocks per shard
    w: int                         # band half-width in inner blocks
    slabs: np.ndarray              # (P, E, nbl, 2w+1, ibs, ibs) f32
    S_csr: List[scipy.sparse.csr_matrix]   # permuted+padded, per E
    # block connectivity: needs[b] = sorted source shards with edges INTO
    # shard b (includes b itself if it has intra-shard edges)
    needs: List[np.ndarray] = field(default_factory=list)
    bandwidth: int = 0             # max |shard_src - shard_dst|

    @property
    def is_ring(self) -> bool:
        """True if one left/right halo exchange of w*inner_bs nodes covers
        all in-edges (the scaling path)."""
        return self.w <= self.nbl

    @property
    def halo(self) -> int:
        """Halo width in nodes exchanged with each ring neighbor."""
        return self.w * self.inner_bs

    @property
    def n_edge_features(self) -> int:
        return len(self.S_csr)

    @property
    def S_perm(self) -> np.ndarray:
        """Dense (E, Np, Np) permuted GSO — small-graph tests/debug only."""
        if self.n_padded > _DENSE_OK_N:
            raise MemoryError(
                f"refusing to densify N={self.n_padded} partitioned GSO; "
                "the sparse path exists to avoid exactly this")
        return np.stack([np.asarray(m.todense()) for m in self.S_csr])

    def pad_signal(self, x: np.ndarray) -> np.ndarray:
        """Reorder (..., N) by the partition order and zero-pad to n_padded."""
        x = np.asarray(x)[..., self.order]
        pad = self.n_padded - self.n_orig
        if pad:
            x = np.concatenate(
                [x, np.zeros(x.shape[:-1] + (pad,), x.dtype)], axis=-1)
        return x

    def unpad_signal(self, x: np.ndarray) -> np.ndarray:
        """Inverse of pad_signal (trims padding, undoes the order)."""
        x = np.asarray(x)[..., :self.n_orig]
        inv = np.empty_like(self.order)
        inv[self.order] = np.arange(self.n_orig)
        return x[..., inv]


def _rcm_order(coos: List[scipy.sparse.coo_matrix]) -> np.ndarray:
    """Reverse-Cuthill-McKee on the union support of all edge features."""
    N = coos[0].shape[0]
    rows = np.concatenate([c.row for c in coos])
    cols = np.concatenate([c.col for c in coos])
    data = np.ones(len(rows), dtype=np.float32)
    A = scipy.sparse.csr_matrix((data, (rows, cols)), shape=(N, N))
    return np.asarray(
        scipy.sparse.csgraph.reverse_cuthill_mckee(A, symmetric_mode=False))


def partition_nodes(S, n_parts: int, order: str = "rcm",
                    inner_block: int = 128,
                    max_slab_bytes: int = 8 << 30) -> GraphPartition:
    """Partition the GSO's nodes into `n_parts` contiguous shard blocks.

    S: dense (N,N)/(E,N,N), scipy sparse, or list of scipy sparse (per E).
    order: 'rcm' (locality-preserving, default) or 'none'.
    inner_block: MXU tile granularity for shards wider than it.
    """
    coos = _to_coo_list(S)
    E = len(coos)
    N = coos[0].shape[0]
    perm = _rcm_order(coos) if order == "rcm" else np.arange(N)
    inv = np.empty(N, dtype=np.int64)
    inv[perm] = np.arange(N)

    # geometry: shard block size, inner tile size
    raw_bs = -(-N // n_parts)
    if raw_bs <= inner_block:
        bs, ibs = raw_bs, raw_bs
    else:
        bs = -(-raw_bs // inner_block) * inner_block
        ibs = inner_block
    nbl = bs // ibs
    n_pad = bs * n_parts
    total_nb = n_parts * nbl

    # permuted coordinates + band half-width (inner-block units)
    pr = [inv[c.row] for c in coos]
    pc = [inv[c.col] for c in coos]
    w = 0
    for e in range(E):
        if len(pr[e]):
            w = max(w, int(np.max(np.abs(pr[e] // ibs - pc[e] // ibs))))
    W = 2 * w + 1

    slab_bytes = n_parts * E * nbl * W * ibs * ibs * 4
    if slab_bytes > max_slab_bytes:
        raise MemoryError(
            f"band slab would be {slab_bytes/2**30:.1f} GiB (w={w} inner "
            f"blocks of {ibs}); the ordered graph is not banded enough — "
            "use a locality-preserving order or coarser partition")

    # build band slabs directly from sparse coordinates (vectorized scatter);
    # slab[j, k] = S[block j+k-w, block j] (output block column j)
    slabs = np.zeros((E, total_nb, W, ibs, ibs), dtype=np.float32)
    csrs = []
    for e in range(E):
        r, c, v = pr[e], pc[e], coos[e].data.astype(np.float32)
        brow, bcol = r // ibs, c // ibs
        k = brow - bcol + w
        np.add.at(slabs[e], (bcol, k, r % ibs, c % ibs), v)
        csrs.append(scipy.sparse.csr_matrix((v, (r, c)),
                                            shape=(n_pad, n_pad)))
    # (E, P*nbl, W, ibs, ibs) -> (P, E, nbl, W, ibs, ibs)
    slabs = slabs.reshape(E, n_parts, nbl, W, ibs, ibs).transpose(
        1, 0, 2, 3, 4, 5).copy()

    # shard-level connectivity (from sparse coordinates, no dense pass)
    needs: List[np.ndarray] = []
    bandwidth = 0
    all_r = np.concatenate(pr) if E > 1 else pr[0]
    all_c = np.concatenate(pc) if E > 1 else pc[0]
    sr, sc = all_r // bs, all_c // bs
    for b in range(n_parts):
        src = np.unique(sr[sc == b])
        needs.append(src.astype(np.int32))
        if len(src):
            bandwidth = max(bandwidth, int(np.max(np.abs(src - b))))

    return GraphPartition(n_parts=n_parts, n_orig=N, n_padded=n_pad,
                          block_size=bs, order=perm, inner_bs=ibs, nbl=nbl,
                          w=w, slabs=slabs, S_csr=csrs, needs=needs,
                          bandwidth=bandwidth)


@dataclass
class BcsrPartition:
    """Node partition for SCATTERED graphs (RCM bandwidth ~ N, where the
    band slab would degenerate dense): each shard stores only the nonzero
    (inner_bs x inner_bs) blocks of its column slice of S, plus the
    transposed layout for gradients. Per-shard memory is O(nnzb/P *
    inner_bs^2), independent of the graph's bandwidth. Shards are padded to
    the largest per-shard block count with zero blocks at (brow = 0, bcol =
    the last block column), which keeps each layout sorted by column and
    adds exact zeros. Signal exchange is one all-gather of the node axis
    per shift (scattered columns can read any row).
    """
    n_parts: int
    n_orig: int
    n_padded: int
    block_size: int                # nodes per shard (output columns)
    order: np.ndarray
    inner_bs: int
    blocks: np.ndarray             # (P, E, nnzb_max, ibs, ibs) f32
    brow: np.ndarray               # (P, E, nnzb_max) int32, global blocks
    bcol: np.ndarray               # (P, E, nnzb_max) int32, LOCAL blocks
    blocks_t: np.ndarray           # transposed layout (for the backward)
    brow_t: np.ndarray             # (P, E, nnzbt_max) int32, LOCAL blocks
    bcol_t: np.ndarray             # (P, E, nnzbt_max) int32, global blocks
    nnzb: np.ndarray               # (P,) true per-shard block counts
    S_csr: List[scipy.sparse.csr_matrix] = field(default_factory=list)

    @property
    def n_edge_features(self) -> int:
        return self.blocks.shape[1]

    @property
    def shard_bytes(self) -> int:
        """Per-shard GSO storage (forward + transposed layouts)."""
        per = self.blocks[0].nbytes + self.brow[0].nbytes \
            + self.bcol[0].nbytes
        pert = self.blocks_t[0].nbytes + self.brow_t[0].nbytes \
            + self.bcol_t[0].nbytes
        return per + pert

    S_perm = GraphPartition.S_perm
    pad_signal = GraphPartition.pad_signal
    unpad_signal = GraphPartition.unpad_signal


def partition_nodes_bcsr(S, n_parts: int, order: str = "none",
                         inner_block: int = 128) -> BcsrPartition:
    """Edge-partition a scattered GSO: per-shard BCSR of its column slice.
    order: 'none' (default: these graphs have no band order worth
    finding) or 'rcm'."""
    coos = _to_coo_list(S)
    E = len(coos)
    N = coos[0].shape[0]
    perm = _rcm_order(coos) if order == "rcm" else np.arange(N)
    inv = np.empty(N, dtype=np.int64)
    inv[perm] = np.arange(N)

    ibs = min(inner_block, -(-N // n_parts))
    bs = -(-(-(-N // n_parts)) // ibs) * ibs
    n_pad = bs * n_parts
    nb_in = n_pad // ibs
    nbl = bs // ibs

    # per-(shard, E) BCSR of the (n_pad x bs) column slice
    per = [[None] * E for _ in range(n_parts)]
    pert = [[None] * E for _ in range(n_parts)]
    csrs = []
    for e in range(E):
        r = inv[coos[e].row]
        c = inv[coos[e].col]
        v = coos[e].data.astype(np.float32)
        csrs.append(scipy.sparse.csr_matrix((v, (r, c)),
                                            shape=(n_pad, n_pad)))
        for p in range(n_parts):
            sel = (c >= p * bs) & (c < (p + 1) * bs)
            Sp = np.zeros((n_pad, bs), np.float32)
            Sp[r[sel], c[sel] - p * bs] = v[sel]
            # block extraction at inner_bs granularity
            tiles = Sp.reshape(nb_in, ibs, nbl, ibs).transpose(0, 2, 1, 3)
            nz = np.abs(tiles).sum(axis=(2, 3)) > ZERO_TOL
            br, bc = np.nonzero(nz)
            o = np.lexsort((br, bc))
            br, bc = br[o], bc[o]
            if len(br) == 0:
                br, bc = np.array([0]), np.array([0])
            blk = tiles[br, bc]
            per[p][e] = (blk.astype(np.float32), br.astype(np.int32),
                         bc.astype(np.int32))
            pert[p][e] = spmm.bcsr_transpose(blk, br, bc)

    def pad_stack(entries, pad_col):
        """Pad each shard's block list to the largest count with ZERO
        blocks at (brow = 0, bcol = pad_col). pad_col is >= every real
        bcol, so the appended pads keep bcsr_matmul's sorted-by-block-
        column precondition (its segment offsets, found by searchsorted,
        would otherwise silently compute wrong outputs); the zero data
        adds exact zeros."""
        mx = max(len(b) for b, _, _ in entries)
        B = np.zeros((len(entries), mx, ibs, ibs), np.float32)
        Rr = np.zeros((len(entries), mx), np.int32)
        Cc = np.full((len(entries), mx), pad_col, np.int32)
        for i, (b, rr, cc) in enumerate(entries):
            if len(cc) and cc[-1] > pad_col:
                raise ValueError(f"block column {cc[-1]} past the pad "
                                 f"column {pad_col}")
            B[i, :len(b)] = b
            Rr[i, :len(b)] = rr
            Cc[i, :len(b)] = cc
        return B, Rr, Cc

    fw = pad_stack([per[p][e] for p in range(n_parts) for e in range(E)],
                   nbl - 1)
    tw = pad_stack([pert[p][e] for p in range(n_parts) for e in range(E)],
                   nb_in - 1)
    shp = lambda a: a.reshape((n_parts, E) + a.shape[1:])
    nnzb = np.array([sum(len(per[p][e][0]) for e in range(E))
                     for p in range(n_parts)])
    return BcsrPartition(
        n_parts=n_parts, n_orig=N, n_padded=n_pad, block_size=bs,
        order=perm, inner_bs=ibs,
        blocks=shp(fw[0]), brow=shp(fw[1]), bcol=shp(fw[2]),
        blocks_t=shp(tw[0]), brow_t=shp(tw[1]), bcol_t=shp(tw[2]),
        nnzb=nnzb, S_csr=csrs)
