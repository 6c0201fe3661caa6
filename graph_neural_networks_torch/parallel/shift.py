"""Sharded graph shifts over a device mesh (``y = x @ S`` node-sharded).

The port of the JAX package's ``parallel/shift.py`` (its shard_map paths).
S is stored sharded (``parallel.partition``), never as a dense ``E x N x
N`` array:

  * ``sharded_gshift_ring``: the halo exchange. When the ordered graph is
    banded (``GraphPartition.is_ring``), each shard needs only the ``w *
    inner_bs`` boundary nodes of its two neighbour shards: the halo strips
    are copied to its device (zeros beyond the global ends), and the shard
    contracts its own block and the halos against its local slab.
  * ``sharded_gshift_allgather``: any band. Each shard gathers the whole
    node axis, slices its halo-extended window and runs the same local
    contraction as the ring.
  * ``sharded_gshift_bcsr``: scattered graphs (a ``BcsrPartition``). Each
    shard gathers the node axis and contracts it against the BCSR blocks
    of its column slice of S (``spmm.bcsr_shift_rect``, the ``bcsr_matmul``
    kernel on a rectangular layout, forward and backward).

Single-controller, as the JAX shard_map: the shards are a loop over the
mesh's coordinates; inputs and outputs are global tensors on the mesh's
home device. The all-gather is a concatenation of the shards' blocks,
built once on each distinct device of the mesh (on one card, one
device-local copy); autograd sums the shards' input gradients through it,
as JAX's psum-scatter does. The band shifts have two shard-local
contractions, as in the JAX package:

  * on a CUDA mesh: the square local band on ``spmm.BandShift`` (the
    ``band_matmul`` kernel) on the shard's own block, plus the O(w^2)
    halo corrections as small einsums; a ring whose shard boundaries carry
    no edge skips the exchange. An inner block that is not a multiple of
    ``spmm.TILE_N`` raises, for the BCSR shift too: a kernel never quietly
    gives way to its plain version on the card,
  * on the CPU: the windowed block einsum (the ring splits off the
    interior blocks, which read only the own block).

All are differentiable by autograd. Each shift is a :class:`ShardShift`
holding its per-shard tables; ``ShardShift.cast`` gives a twin with the
float tables (slabs, halo corrections, BCSR blocks) cast once and the
integer ones (block indices, segment offsets) shared, which a bf16
``ShardedGso`` shifts with: its local contraction then runs on the bf16
kernels (kernel 3b on the square local band, 1b on the rectangular BCSR
slice) and its halo corrections are bf16 einsums. ``make_dp_train_step``
(a GSPMD data-parallel step) is not ported (ROADMAP queue 1 item 10.2b).

Signals follow the gshift convention: x (..., E, G, N_padded), node axis
last, ordered and padded by the partition; any number of leading dims.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from graph_neural_networks_torch.ops import spmm
from graph_neural_networks_torch.parallel.mesh import Mesh, halo_strips
from graph_neural_networks_torch.parallel.partition import (
    BcsrPartition, GraphPartition)


def _sq_slabs(part: GraphPartition):
    """Per-shard SQUARE local band slabs + boundary-correction blocks for
    the kernel's shard-local path (JAX ``parallel/shift.py:_sq_slabs``).

    The kernel runs on the UNEXTENDED local block with the slab entries
    that reference the halo zeroed, and the halo terms are added as
    O(w^2) small block einsums fed directly by the halos.

    Returns (s_sq, s_sq_t, lo, hi):
      s_sq / s_sq_t: (P, E, nbl, (2w+1)*ibs, ibs) band_matmul layout,
        entries with j+k-w outside [0, nbl) zeroed (s_sq_t is the
        transposed band, for BandShift's backward);
      lo: (P, E, w, w, ibs, ibs) -- lo[j, lb] multiplies from_left
        block lb into output block j (= slab[j, lb-j], j <= lb < w);
      hi: (P, E, w, w, ibs, ibs) -- hi[j_rel, rb] multiplies from_right
        block rb into output block nbl-w+j_rel
        (= slab[nbl-w+j_rel, 2w-j_rel+rb], rb <= j_rel).

    Any w: past the ring (w > nbl, the all-gather shift) the halo terms of
    the output blocks that do not exist are left out (lo rows j >= nbl,
    hi rows with nbl-w+j_rel < 0).
    """
    Pn, E, nbl, W, ibs, _ = part.slabs.shape
    w = part.w
    s_sq = np.array(part.slabs, np.float32, copy=True)
    for j in range(nbl):
        for k in range(W):
            if not 0 <= j + k - w < nbl:
                s_sq[:, :, j, k] = 0.0
    s_sq_t = np.zeros_like(s_sq)
    for j in range(nbl):
        for k in range(W):
            src = j + k - w
            if 0 <= src < nbl:
                s_sq_t[:, :, j, k] = np.swapaxes(
                    s_sq[:, :, src, 2 * w - k], -1, -2)
    lo = np.zeros((Pn, E, w, w, ibs, ibs), np.float32)
    hi = np.zeros((Pn, E, w, w, ibs, ibs), np.float32)
    for j in range(min(w, nbl)):
        for lb in range(j, w):
            lo[:, :, j, lb] = part.slabs[:, :, j, lb - j]
    for j_rel in range(w):
        j = nbl - w + j_rel
        if j < 0:
            continue
        for rb in range(j_rel + 1):
            hi[:, :, j_rel, rb] = part.slabs[:, :, j, 2 * w - j_rel + rb]
    shape = (Pn, E, nbl, W * ibs, ibs)
    return s_sq.reshape(shape), s_sq_t.reshape(shape), lo, hi


def _kernel_local_contract(x_blk, from_left, from_right, s_sq, s_sq_t, lo,
                           hi, w, ibs, nbl):
    """Shard-local band contraction on the band_matmul kernel: the square
    local band on the UNEXTENDED block + the boundary-correction einsums
    on the halos. x_blk: (L, E, G, nbl*ibs); from_left/from_right:
    (L, E, G, w*ibs), or None when the shard boundary carries no edge (lo
    and hi are zero: the corrections are skipped). For w > nbl the w
    correction blocks of each side overhang the shard: the negative pad
    crops them to its nbl blocks (the first nbl of the left ones, the last
    nbl of the right ones)."""
    L, E, G, n_loc = x_blk.shape
    y = torch.stack([
        spmm.BandShift.apply(x_blk[:, e].reshape(L * G, n_loc), s_sq[e],
                             s_sq_t[e], n_loc, w, ibs).reshape(L, G, n_loc)
        for e in range(E)], dim=1)                # L, E, G, nbl*ibs
    if w and from_left is not None:
        fl = from_left.reshape(L, E, G, w, ibs)
        fr = from_right.reshape(L, E, G, w, ibs)
        cl = torch.einsum("legbn,ejbnm->legjm", fl, lo).reshape(
            L, E, G, w * ibs)
        ch = torch.einsum("legbn,ejbnm->legjm", fr, hi).reshape(
            L, E, G, w * ibs)
        pad = (nbl - w) * ibs
        y = (y + torch.nn.functional.pad(cl, (0, pad))
             + torch.nn.functional.pad(ch, (pad, 0)))
    return y


def _band_contract(x_ext: torch.Tensor, slab: torch.Tensor) -> torch.Tensor:
    """Local windowed band contraction. x_ext: (L, E, G, (nbl + 2w) * ibs)
    halo-extended signal block; slab: (E, nbl, 2w+1, ibs, ibs) (slab[e, j,
    k] multiplies input inner block j+k). Returns (L, E, G, nbl * ibs)."""
    E, nbl, W, ibs, _ = slab.shape
    L, _, G, _ = x_ext.shape
    xb = x_ext.reshape(L, E, G, nbl + W - 1, ibs)
    win = torch.stack([xb[:, :, :, k:k + nbl] for k in range(W)], dim=4)
    y = torch.einsum("legjkn,ejknm->legjm", win, slab)
    return y.reshape(L, E, G, nbl * ibs)


def _window_local_contract(x_blk, from_left, from_right, slab, w, ibs, nbl):
    """The windowed shard-local contraction: interior output blocks
    [w, nbl-w) read only the own block; the w boundary blocks at each end
    read a halo."""
    if nbl <= 2 * w:
        return _band_contract(
            torch.cat([from_left, x_blk, from_right], dim=-1), slab)
    y_int = _band_contract(x_blk, slab[:, w:nbl - w])
    x_lo = torch.cat([from_left, x_blk[..., :2 * w * ibs]], dim=-1)
    x_hi = torch.cat([x_blk[..., -(2 * w) * ibs:], from_right], dim=-1)
    return torch.cat([_band_contract(x_lo, slab[:, :w]), y_int,
                      _band_contract(x_hi, slab[:, nbl - w:])], dim=-1)


def _uses_kernel(mesh: Mesh, part, kernel: str) -> bool:
    """The JAX ``use_pallas`` rule in the port's terms: the shard-local
    kernel on a CUDA mesh, which raises on an inner block the kernel
    cannot take."""
    if mesh.home.type != "cuda":
        return False
    if part.inner_bs % spmm.TILE_N:
        raise ValueError(
            f"the {kernel} kernel needs the partition's inner block a "
            f"multiple of TILE_N={spmm.TILE_N}, got inner_bs="
            f"{part.inner_bs}; shard into fewer parts")
    return True


def _uses_band_kernel(mesh: Mesh, part: GraphPartition) -> bool:
    return _uses_kernel(mesh, part, "band_matmul")


def _check_axis(mesh: Mesh, axis: str, part) -> None:
    if mesh.shape[axis] != part.n_parts:
        raise ValueError(f"mesh axis {axis!r} has {mesh.shape[axis]} "
                         f"devices for {part.n_parts} graph shards")


def _per_shard(grid, arrays) -> dict:
    """{(device, p): shard p's slice of each array, on that device}, built
    once on every device that runs shard p."""
    out = {}
    for devs in grid:
        for p, dev in enumerate(devs):
            if (dev, p) not in out:
                out[dev, p] = tuple(torch.as_tensor(a[p], device=dev)
                                    for a in arrays)
    return out


def _all_gather(blks, devs) -> dict:
    """{device: the whole (L, E, G, N_padded) signal}: the shards' blocks
    concatenated once on each distinct device of the row."""
    return {dev: torch.cat([b.to(dev) for b in blks], dim=-1)
            for dev in dict.fromkeys(devs)}


class ShardShift:
    """shift(x) on global (..., E, G, N_padded) tensors from a shard-local
    step: the leading dims flatten into L, which the data rows of `grid`
    split when they divide it (else the first data row takes all of it, as
    the JAX ShardedGso falls back to its graph-only shift). For each data
    row, ``prepare(blks, devs)`` exchanges what the shards need (halo
    strips, the all-gather) and ``local(p, dev, blk, exchanged, tables)``
    maps shard p's (L_d, E, G, bs) block to its (L_d, E, G, bs) output,
    reading its tables at ``tables[dev, p]`` (:func:`_per_shard`)."""

    def __init__(self, grid, bs: int, prepare, local, tables: dict):
        self.grid, self.bs = grid, bs
        self.prepare, self.local, self.tables = prepare, local, tables

    def cast(self, dtype: torch.dtype) -> "ShardShift":
        """A twin whose float tables are in `dtype` (cast once, here), the
        integer ones shared."""
        tables = {key: tuple(t.to(dtype) if t.is_floating_point() else t
                             for t in ts)
                  for key, ts in self.tables.items()}
        return ShardShift(self.grid, self.bs, self.prepare, self.local,
                          tables)

    def _shift4(self, x):
        grid, bs = self.grid, self.bs
        L = x.shape[0]
        rows = grid if L % len(grid) == 0 else grid[:1]
        Ld = L // len(rows)
        ys = []
        for d, devs in enumerate(rows):
            blks = [x[d * Ld:(d + 1) * Ld, ..., p * bs:(p + 1) * bs]
                    .to(dev).contiguous() for p, dev in enumerate(devs)]
            exchanged = self.prepare(blks, devs)
            y = [self.local(p, dev, blks[p], exchanged, self.tables)
                 for p, dev in enumerate(devs)]
            ys.append(torch.cat([t.to(x.device) for t in y], dim=-1))
        return torch.cat(ys) if len(ys) > 1 else ys[0]

    def __call__(self, x):
        lead = x.shape[:-3]
        y = self._shift4(x.reshape((-1,) + tuple(x.shape[-3:])))
        return y.reshape(tuple(lead) + tuple(y.shape[-3:]))


def sharded_gshift_ring(mesh: Mesh, part: GraphPartition,
                        axis: str = "graph",
                        data_axis: Optional[str] = None) -> ShardShift:
    """Halo-exchange shift: each shard receives the w*inner_bs boundary
    nodes of its neighbours and contracts against its local band slab.
    Requires part.is_ring. data_axis: also split the flattened leading
    (batch) dim over this mesh axis when it divides it (else the shards of
    the first data slice take all of it, as the JAX ShardedGso falls back
    to its graph-only shift). Returns shift(x) on global
    (..., E, G, N_padded) tensors."""
    if not part.is_ring:
        raise ValueError(
            f"band half-width w={part.w} inner blocks exceeds the shard "
            f"width (nbl={part.nbl}); use sharded_gshift_allgather or a "
            "locality order")
    _check_axis(mesh, axis, part)
    w, nbl, ibs, halo = part.w, part.nbl, part.inner_bs, part.halo
    bs = part.block_size
    grid = mesh.grid(axis, data_axis)
    use_kernel = _uses_band_kernel(mesh, part)
    if use_kernel:
        sq = _sq_slabs(part)
        # no cross-shard edge anywhere (always at n_parts=1): the halo
        # exchange and the corrections are zero, skip both
        has_boundary = bool(sq[2].any() or sq[3].any())
        slabs = _per_shard(grid, sq)
    else:
        has_boundary = True
        slabs = _per_shard(grid, (part.slabs,))
    exchange = bool(halo) and has_boundary

    def prepare(blks, _):
        return (halo_strips(blks, halo) if exchange
                else [(None, None)] * len(blks))

    def local(p, dev, blk, halos, tables):
        s = tables[dev, p]
        if use_kernel:
            return _kernel_local_contract(blk, *halos[p], *s, w, ibs, nbl)
        if halo == 0:
            return _band_contract(blk, s[0])
        return _window_local_contract(blk, *halos[p], s[0], w, ibs, nbl)

    return ShardShift(grid, bs, prepare, local, slabs)


def sharded_gshift_allgather(mesh: Mesh, part: GraphPartition,
                             axis: str = "graph",
                             data_axis: Optional[str] = None) -> ShardShift:
    """All-gather shift: each shard gathers the node axis, slices its
    halo-extended window (zeros beyond the global ends) and contracts it
    against its local band slab, as the ring does. Exact for any
    bandwidth (w may exceed nbl); the slabs stay sharded. data_axis as for
    :func:`sharded_gshift_ring`."""
    _check_axis(mesh, axis, part)
    w, nbl, ibs, halo = part.w, part.nbl, part.inner_bs, part.halo
    bs = part.block_size
    grid = mesh.grid(axis, data_axis)
    use_kernel = _uses_band_kernel(mesh, part)
    slabs = _per_shard(grid, _sq_slabs(part) if use_kernel
                       else (part.slabs,))

    def local(p, dev, _, full, tables):
        xp = torch.nn.functional.pad(full[dev], (halo, halo))
        x_ext = xp[..., p * bs:p * bs + bs + 2 * halo]
        s = tables[dev, p]
        if use_kernel:
            return _kernel_local_contract(
                x_ext[..., halo:halo + bs].contiguous(), x_ext[..., :halo],
                x_ext[..., halo + bs:], *s, w, ibs, nbl)
        return _band_contract(x_ext, s[0])

    return ShardShift(grid, bs, _all_gather, local, slabs)


def sharded_gshift_bcsr(mesh: Mesh, part: BcsrPartition,
                        axis: str = "graph",
                        data_axis: Optional[str] = None) -> ShardShift:
    """Sharded shift for SCATTERED graphs (a ``BcsrPartition``): each shard
    gathers the node axis and contracts it against the BCSR blocks of its
    column slice of S, one ``spmm.bcsr_shift_rect`` an edge feature
    (per-shard GSO memory O(nnzb/P * ibs^2), whatever the bandwidth). On a
    CUDA mesh that is the bcsr_matmul kernel on the rectangular layout,
    forward and backward, with each layout's segment offsets computed here
    once; on the CPU its plain version. data_axis as for
    :func:`sharded_gshift_ring`."""
    if not isinstance(part, BcsrPartition):
        raise TypeError(f"sharded_gshift_bcsr takes a BcsrPartition, got "
                        f"{type(part).__name__}")
    _check_axis(mesh, axis, part)
    bs, ibs, Np = part.block_size, part.inner_bs, part.n_padded
    grid = mesh.grid(axis, data_axis)
    _uses_kernel(mesh, part, "bcsr_matmul")
    cs = np.stack([[spmm.bcsr_col_start(part.bcol[p, e], bs, ibs)
                    for e in range(part.n_edge_features)]
                   for p in range(part.n_parts)])
    cs_t = np.stack([[spmm.bcsr_col_start(part.bcol_t[p, e], Np, ibs)
                      for e in range(part.n_edge_features)]
                     for p in range(part.n_parts)])
    layouts = _per_shard(grid, (part.blocks, part.brow, part.bcol, cs,
                                part.blocks_t, part.brow_t, part.bcol_t,
                                cs_t))

    def local(p, dev, _, full, tables):
        blocks, brow, bcol, c, blocks_t, brow_t, bcol_t, c_t = \
            tables[dev, p]
        x_full = full[dev]
        L, E, G, _ = x_full.shape
        return torch.stack([
            spmm.bcsr_shift_rect(
                x_full[:, e].reshape(L * G, Np), blocks[e], brow[e],
                bcol[e], blocks_t[e], brow_t[e], bcol_t[e], bs, Np, ibs,
                c[e], c_t[e]).reshape(L, G, bs)
            for e in range(E)], dim=1)

    return ShardShift(grid, bs, _all_gather, local, layouts)
