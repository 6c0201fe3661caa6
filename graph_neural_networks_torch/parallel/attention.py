"""Node-sharded banded attention (GAT family) over a device mesh.

The port of the JAX package's ``parallel/attention.py``. Each
graph shard owns a contiguous block of (ordered) nodes and keeps only its
band slab and support masks (``parallel.partition``), on its own device.
One attention application is three steps, as in the JAX shard_map:

  1. halo-extend the score projections a1, a2 and the signal v: each
     shard gets w*ibs boundary nodes from each neighbour shard,
  2. per shard, the softmax stats of each OWN row over its full column
     window (rows never straddle the halo: w <= nbl), then halo-extend
     the stats, so a neighbour row's denominator is exact,
  3. per shard, alpha recomputed and aggregated for the shard's own
     output columns.

The JAX package is single-controller (one process, shard_map over the
mesh); so is this module: the shards are a loop over the mesh's
coordinates, and a halo exchange is an explicit copy of each boundary
strip to its neighbour's device, with zeros at the global ends (the
boundary condition of JAX's non-circular ``ppermute``). Inputs and
outputs are global tensors on the mesh's home device.

Two shard-local steps, chosen as in the JAX package (``local_flash``):

  * the flash kernels, ``ops.attention_flash.stats_ext_call`` and
    ``apply_ext_call`` (kernels 10-11) forward and ``bwd_ext_call``
    (kernel 12) backward, as the JAX ``_make_flash`` custom VJP: alpha
    never exists, not even shard-locally. The forward keeps each shard's
    halo-extended a1, its own a2 and v and its stats (never alpha); the
    backward halo-extends the cotangent, runs the ext backward per shard,
    folds its da1 window partials into ext columns and ``halo_fold``s the
    halo columns back to the shards that own them. S is read there from a
    halo-extended column slab (the JAX package keeps a row-layout slab,
    ``_row_slabs``, instead; see :func:`_ext_slabs`).
  * the windowed path, their plain versions ``stats_ext_plain`` and
    ``apply_ext_plain``: plain torch, differentiable by autograd through
    the halo copies, as the JAX ``_make`` is by autodiff.

Orientation and masking match the reference exactly (graphML.py:713,
807): e_ij = LeakyReLU(a2.Wx_i + a1.Wx_j), softmax over row i's window,
y at column m aggregates alpha-weighted rows, mask arithmetic
``e*mask - (1-mask)*1e12`` then ``alpha*mask``.
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch

from graph_neural_networks_torch.ops import attention_flash as af
from graph_neural_networks_torch.parallel.mesh import (Mesh, halo_ext,
                                                       halo_fold)
from graph_neural_networks_torch.parallel.partition import GraphPartition


def _row_col_masks(part: GraphPartition):
    """Host-side 0/1 support masks of S+I in both window layouts.

    mask_col[jb, k] = support block (rows jb+k-w, cols jb)   (ext rows)
    mask_row[ib, k] = support block (rows ib, cols ib+k-w)   (ext cols)
    Shapes: (P, nbl, W, ibs, ibs) each. The identity covers only real
    nodes (padded rows stay fully masked -> zero output, like the
    reference's N-node S+I).
    """
    ibs, nbl, w = part.inner_bs, part.nbl, part.w
    W = 2 * w + 1
    total_nb = part.n_parts * nbl
    mc = np.zeros((total_nb, W, ibs, ibs), np.float32)
    mr = np.zeros((total_nb, W, ibs, ibs), np.float32)
    for csr in part.S_csr:
        coo = csr.tocoo()
        r, c = coo.row, coo.col
        keep = np.abs(coo.data) > 1e-9
        r, c = r[keep], c[keep]
        br, bc = r // ibs, c // ibs
        if len(r):
            np.add.at(mc, (bc, br - bc + w, r % ibs, c % ibs), 1.0)
            np.add.at(mr, (br, bc - br + w, r % ibs, c % ibs), 1.0)
    diag = np.arange(part.n_orig)
    bd = diag // ibs
    np.add.at(mc, (bd, w, diag % ibs, diag % ibs), 1.0)
    np.add.at(mr, (bd, w, diag % ibs, diag % ibs), 1.0)
    shape = (part.n_parts, nbl, W, ibs, ibs)
    return ((mc > 0).astype(np.float32).reshape(shape),
            (mr > 0).astype(np.float32).reshape(shape))


def _ext_slabs(part: GraphPartition) -> np.ndarray:
    """Each shard's column slab halo-extended by its neighbours' w edge
    blocks, (P, E, nbl + 2w, W, ibs, ibs), zeros past the global ends:
    out[p, e, j] = the column-layout slab of global column block
    p*nbl + j - w. The own slab is out[p, :, w:w + nbl]; the flash
    backward reads S in the row layout at out[p, e, i + k, 2w - k]
    (``attention_flash.ext_row_layout``), which for a shard's first and
    last w row blocks lies in a neighbour's columns. One slab a shard,
    (nbl + 2w) / nbl of the own one, where a row-layout slab (the JAX
    ``_row_slabs``) would add a second as large."""
    Pn, E, nbl, W, ibs, _ = part.slabs.shape
    w = part.w
    flat = np.concatenate(list(part.slabs), axis=1)  # E, Pn*nbl, W, ibs, ibs
    flat = np.pad(flat, ((0, 0), (w, w), (0, 0), (0, 0), (0, 0)))
    return np.stack([flat[:, p * nbl:(p + 1) * nbl + 2 * w]
                     for p in range(Pn)])


class ShardedBandAttention:
    """Sharded attention operator bound to a mesh and a GraphPartition.

    :meth:`apply` computes ``y = v @ (S_e * alpha_e(a1x, a2x))`` (or
    alpha alone, the GCAT shift) for signals whose node axis is ordered and
    padded by the partition. The GAT-family entry points are
    :func:`sharded_graph_attention` etc.

    local_flash: None takes the flash kernels on a CUDA mesh and the
    windowed path on the CPU; True runs the flash schedule (on the CPU
    through the kernels' plain versions); False runs the windowed path.
    On a CUDA mesh the flash schedule raises here when the partition's
    inner block is not a multiple of the kernels' column tile
    (``attention_flash.TILE_N``): the kernels never quietly give way to
    their plain versions on the card.
    data_axis: also split the folded batch rows Q over this mesh axis
    (when it divides Q).
    """

    def __init__(self, mesh: Mesh, part: GraphPartition,
                 axis: str = "graph", data_axis: Optional[str] = None,
                 local_flash: Optional[bool] = None):
        if not part.is_ring:
            raise ValueError(
                f"sharded attention needs the ring property (w={part.w} <= "
                f"nbl={part.nbl}); re-partition with a locality order")
        if mesh.shape[axis] != part.n_parts:
            raise ValueError(f"mesh axis {axis!r} has {mesh.shape[axis]} "
                             f"devices for {part.n_parts} graph shards")
        self.mesh, self.part = mesh, part
        self.axis, self.data_axis = axis, data_axis
        on_cuda = mesh.home.type == "cuda"
        if local_flash is None:
            local_flash = on_cuda
        if local_flash and on_cuda and part.inner_bs % af.TILE_N:
            raise ValueError(
                f"the flash kernels need the partition's inner block a "
                f"multiple of TILE_N={af.TILE_N}, got inner_bs="
                f"{part.inner_bs}; shard into fewer parts or pass "
                "local_flash=False for the windowed path")
        self.use_flash = bool(local_flash)
        self.grid = mesh.grid(axis, data_axis)
        # each shard's halo-extended slab (E, nbl + 2w, W, ibs, ibs), its
        # own slab (a view of it), masks (nbl, W, ibs, ibs) and, for the
        # flash apply, the column mask's entry lists, built once on every
        # device that runs that shard
        mc, mr = _row_col_masks(part)
        slabs_ext = _ext_slabs(part)
        w, nbl = part.w, part.nbl
        self._shard_ops = {}
        for devs in self.grid:
            for p, dev in enumerate(devs):
                if (dev, p) not in self._shard_ops:
                    ext, mcol, mrow = (torch.as_tensor(t[p], device=dev)
                                       for t in (slabs_ext, mc, mr))
                    lists = (af.support_lists_or_empty(mcol)
                             if self.use_flash else None)
                    self._shard_ops[dev, p] = (ext[:, w:w + nbl], mcol,
                                               mrow, ext, lists)

    def cast(self, dtype: torch.dtype) -> "ShardedBandAttention":
        """A twin on the same mesh and partition whose shards' slabs and
        masks are in `dtype` (cast once, here; the own slab a view of the
        cast halo-extended one), the support's entry lists shared: what a
        bf16 ShardedGso attends with."""
        twin = copy.copy(self)
        w, nbl = self.part.w, self.part.nbl
        twin._shard_ops = {}
        for key, (_, mcol, mrow, ext, lists) in self._shard_ops.items():
            ext = ext.to(dtype)
            twin._shard_ops[key] = (ext[:, w:w + nbl], mcol.to(dtype),
                                    mrow.to(dtype), ext, lists)
        return twin

    def apply(self, a1x: torch.Tensor, a2x: torch.Tensor, v: torch.Tensor,
              e: int = 0, with_s: bool = True) -> torch.Tensor:
        """One sharded attention application. a1x, a2x (Q, Np) and v
        (Q, F, Np) on the mesh's home device, node axis ordered and padded
        by the partition (Np = part.n_padded), Q = folded batch * heads.
        Returns (Q, F, Np) there. e selects the edge feature's slab."""
        Q = a1x.shape[0]
        rows = (self.grid if self.data_axis and Q % len(self.grid) == 0
                else self.grid[:1])
        if self.use_flash:
            return _ShardedFlash.apply(a1x, a2x, v, self, rows, e, with_s)
        return self.schedule(a1x, a2x, v, rows, e, with_s,
                             af.stats_ext_plain, af.apply_ext_plain)

    def _shards(self, t, q, devs):
        """Data slice q of the global t cut into its graph shards, each
        on its device."""
        bs = self.part.block_size
        return [t[q, ..., p * bs:(p + 1) * bs].to(dev).contiguous()
                for p, dev in enumerate(devs)]

    def schedule(self, a1x, a2x, v, rows, e, with_s, stats, apply,
                 saved=None):
        """The three steps for each data slice (a row of the device grid)
        with the shard-local functions `stats` and `apply`. `saved`, a
        list when given, receives for each data slice what the flash
        backward needs: the shards' halo-extended a1, own a2 and v, and
        stats."""
        part = self.part
        w, ibs, halo = part.w, part.inner_bs, part.halo
        Qd = a1x.shape[0] // len(rows)
        ys = []
        for d, devs in enumerate(rows):
            q = slice(d * Qd, (d + 1) * Qd)
            a1s, a2s, vs = (self._shards(t, q, devs) for t in (a1x, a2x, v))
            ops = [self._shard_ops[dev, p] for p, dev in enumerate(devs)]
            a1e, a2e, ve = (halo_ext(t, halo) for t in (a1s, a2s, vs))
            st = [stats(a1e[p], a2s[p], ops[p][2], w=w, ibs=ibs)
                  for p in range(len(devs))]
            mxe = halo_ext([s[0] for s in st], halo)
            sme = halo_ext([s[1] for s in st], halo)
            y = [apply(a1s[p], a2e[p], ve[p], mxe[p], sme[p], ops[p][0][e],
                       ops[p][1], w=w, ibs=ibs, with_s=with_s,
                       lists=ops[p][4])
                 for p in range(len(devs))]
            ys.append(torch.cat([t.to(a1x.device) for t in y], dim=-1))
            if saved is not None:
                saved.append((a1e, a2s, vs, st))
        return torch.cat(ys) if len(ys) > 1 else ys[0]

    def schedule_bwd(self, g, rows, saved, e, with_s):
        """The flash backward of :meth:`schedule` for the cotangent g
        (Q, F, Np) on the home device: per data slice, g cut into shards
        and halo-extended, ``bwd_ext_call`` on each shard, its da1 window
        partials folded into ext columns and ``halo_fold``ed back to their
        owners in f32, then da1 and da2 rounded once to the operands' dtype
        (the JAX ``local_bwd``). Returns (da1x, da2x, dv) on g's device."""
        part = self.part
        w, ibs, halo = part.w, part.inner_bs, part.halo
        Qd = g.shape[0] // len(rows)
        outs = []
        for d, (devs, (a1e, a2s, vs, st)) in enumerate(zip(rows, saved)):
            ge = halo_ext(self._shards(g, slice(d * Qd, (d + 1) * Qd), devs),
                          halo)
            ops = [self._shard_ops[dev, p] for p, dev in enumerate(devs)]
            grads = [af.bwd_ext_call(a1e[p], a2s[p], vs[p], *st[p],
                                     ops[p][3][e], ops[p][2], ge[p], w=w,
                                     ibs=ibs, with_s=with_s)
                     for p in range(len(devs))]
            da1 = halo_fold([af.fold_ext_partials(t[1]) for t in grads],
                            halo)
            dt = a2s[0].dtype
            outs.append([torch.cat([t.to(g.device, dt) for t in ts], dim=-1)
                         for ts in (da1, [t[0] for t in grads],
                                    [t[2] for t in grads])])
        return tuple(torch.cat(ts) if len(ts) > 1 else ts[0]
                     for ts in zip(*outs))


class _ShardedFlash(torch.autograd.Function):
    """The flash schedule as a Function, the JAX ``_make_flash`` custom
    VJP: forward kernels 10-11, keeping each shard's operands and stats;
    backward kernel 12 (:meth:`ShardedBandAttention.schedule_bwd`)."""

    @staticmethod
    def forward(ctx, a1x, a2x, v, sattn, rows, e, with_s):
        ctx.saved = []
        ctx.cfg = (sattn, rows, e, with_s)
        return sattn.schedule(a1x, a2x, v, rows, e, with_s,
                              af.stats_ext_call, af.apply_ext_call,
                              saved=ctx.saved)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        sattn, rows, e, with_s = ctx.cfg
        grads = sattn.schedule_bwd(g, rows, ctx.saved, e, with_s)
        need = ctx.needs_input_grad
        return (*(t if n else None for t, n in zip(grads, need)), None,
                None, None, None)


# ---------------------------------------------------------------------------
# GAT-family entry points on sharded signals
# ---------------------------------------------------------------------------

def sharded_graph_attention(x, a, W_p, sattn: ShardedBandAttention,
                            n_out: Optional[int] = None):
    """Sharded GAT layer: y = sum_e Wx (S_e * alpha_e). x: (B, G, Np)
    ordered/padded by the partition; returns (B, P, F, n_out or Np)."""
    B, G, Np = x.shape
    Ph, E, F, _ = W_p.shape
    Wx, a1Wx, a2Wx = af._projections(x, a, W_p)
    a1q = a1Wx.reshape(B * Ph, E, Np)
    a2q = a2Wx.reshape(B * Ph, E, Np)
    vq = Wx.reshape(B * Ph, E, F, Np)
    y = None
    for e in range(E):
        ye = sattn.apply(a1q[:, e], a2q[:, e], vq[:, e], e=e, with_s=True)
        y = ye if y is None else y + ye
    y = y.reshape(B, Ph, F, Np)
    return y if n_out is None else y[..., :n_out]


def sharded_gat_lsigf(h, x, a, W_p, sattn: ShardedBandAttention, b=None):
    """Sharded GCAT: K-tap LSIGF over alpha (shift = alpha alone,
    reference graphML.py:876-879). h: (E,K) -> (B, P, F, Np)."""
    E, K = h.shape
    Ph, _, F, G = W_p.shape
    B, _, Np = x.shape
    _, a1Wx, a2Wx = af._projections(x, a, W_p)
    a1q = a1Wx.reshape(B * Ph, E, Np)
    a2q = a2Wx.reshape(B * Ph, E, Np)
    W_taps = W_p.permute(0, 3, 1, 2).reshape(Ph, F, E, 1, G)
    hW = h[None, None, :, :, None] * W_taps          # P,F,E,K,G
    xe = x[:, None, None].expand(B, Ph, E, G, Np).reshape(B * Ph, E, G, Np)
    zs = [xe]
    for _ in range(1, K):
        xe = torch.stack([
            sattn.apply(a1q[:, e], a2q[:, e], xe[:, e], e=e, with_s=False)
            for e in range(E)], dim=1)
        zs.append(xe)
    z = torch.stack(zs, dim=2).reshape(B, Ph, E, K, G, Np)
    y = torch.einsum("bpekgn,pfekg->bpfn", z, hW)
    return y if b is None else y + b


def sharded_gat_evgf(x, a, W_p, sattn: ShardedBandAttention, b=None):
    """Sharded attention edge-variant filter (per-hop attention,
    cumulative product; reference graphML.py:897-969).
    a: (P,K,E,2F), W_p: (P,K,E,F,G) -> (B, P, F, Np)."""
    Ph, K, E, F, G = W_p.shape
    B, _, Np = x.shape

    def apply_all(k, v):
        _, a1Wx, a2Wx = af._projections(x, a[:, k], W_p[:, k])
        a1q = a1Wx.reshape(B * Ph, E, Np)
        a2q = a2Wx.reshape(B * Ph, E, Np)
        return torch.stack([
            sattn.apply(a1q[:, e], a2q[:, e], v[:, e], e=e, with_s=True)
            for e in range(E)], dim=1)

    v = torch.einsum("pefg,bgn->bpefn", W_p[:, 0], x)
    v = apply_all(0, v.reshape(B * Ph, E, F, Np))
    y = v
    for k in range(1, K):
        v = apply_all(k, v)
        y = y + v
    y = y.sum(dim=1).reshape(B, Ph, F, Np)
    return y if b is None else y + b
