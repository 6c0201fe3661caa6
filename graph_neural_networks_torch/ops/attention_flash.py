"""Flash banded attention: the band-mode GAT family with the attention
coefficients alpha never in device memory.

The port of the JAX package's ``ops/attention_flash.py``. Scores are
recomputed tile by tile in three kernels
(``kernels/csrc/attention_flash.cu``), each behind a wrapper:

  * :func:`stats_call` -- per row: the rowmax and exp-rowsum of the masked
    LeakyReLU scores over the row's column window (softmax denominators).
  * :func:`apply_call` -- per output column block: alpha re-derived from
    (a1x, a2x, stats), times the band slab (or not: GCAT shifts with alpha
    alone), aggregated over v.
  * :func:`bwd_call` -- per row block: the flash backward of apply
    (recompute alpha, dalpha = v^T dy, the softmax VJP, the LeakyReLU
    chain) giving d_a2x, the window partials of d_a1x (folded by
    :func:`fold_window_partials`) and dv.

:class:`FlashApply` is the differentiable primitive (the JAX custom VJP of
``flash_apply``): stats + apply forward, keeping a1x, a2x, v and the
stats (never alpha), and bwd_call backward.

:func:`stats_ext_call`, :func:`apply_ext_call` and :func:`bwd_ext_call`
run the three kernels on one shard's halo-extended layout (the
shard-local step of ``parallel.attention``, whose flash schedule is their
autograd Function): the operands read through the window carry w halo
blocks a side, so window block k of own block j is ext block j + k.

Orientation matches the reference (graphML.py:713, 807): score
e_ij = LeakyReLU(a2.Wx_i + a1.Wx_j), softmax over each ROW i's column
window, output at column m aggregates alpha-weighted rows. Masking keeps
the reference arithmetic: e*mask - (1-mask)*1e12, then alpha*mask.

A wrapper runs its ``*_plain`` version when its inputs lie on the CPU and
launches its kernel when they lie on a CUDA device; it never falls back
from one to the other. Each launch adds one to the wrapper's ``launches``
count. The raw wrappers record no gradient: on CUDA, with grad enabled and
an input that requires grad, they raise NotImplementedError; the entry
points differentiate through :class:`FlashApply`.

stats and apply (kernels 7-8) also take bf16 operands (the stats stay
f32, from ``attn_stats_bf16_kernel``; apply's y is bf16) and go through
``torch.library`` ops,
``torch.ops.gnt.attn_stats`` and ``attn_apply``: a CPU implementation (the
plain version), a CUDA one (the kernel), a fake one (shapes, for
``torch.export`` and ``FlopCounterMode``) and a flop formula; each call
adds one to ``kernels.OP_CALLS[name, dtype]``; on the CPU a call that needs
a gradient runs the plain version directly. The backward (kernel 9) takes
bf16 operands too, as bf16 training runs it: da2 and the da1 partials in
f32, dv in bf16, rounded once (``attn_bwd_mma_kernel`` on tensor cores,
two signal rows a block, F at most 64); :class:`FlashApply` rounds the
folded da1 and da2 to the operands' dtype. The ext kernels (10-12) take
f32 or bf16 alike, as sharded bf16 serving and training run them: the
stats, da2 and the da1 partials in f32, y and dv in v's dtype; their
wrappers count each call in ``kernels.OP_CALLS`` as bwd_call does.

The band structure (:class:`BandAux`: the slab in the column-window
layout and the S+I support in the column- and row-window layouts) is built
once per band-mode ``Gso`` by :func:`band_auxes`, on the Gso's device, and
cached on the Gso (the JAX functions rebuild it inside every call); the
entry points take it as the required ``auxes=``. It includes the support
as entry lists (:class:`SupportLists`), which the apply kernel's scores
walk on CUDA.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn
from torch.utils.flop_counter import register_flop_formula

from graph_neural_networks_torch import kernels

INFINITE = 1e12  # reference's additive -inf (graphML.py:73)

# Output column tile of the apply kernel (kCT in attention_flash.cu): the
# CUDA path needs the block size ibs to be a multiple of it.
TILE_N = 64
# Window rows the apply kernel stages a step (kAP), in 4-row groups.
APPLY_CHUNK = 32


# ---------------------------------------------------------------------------
# Band structure
# ---------------------------------------------------------------------------

def _diag_win(t: torch.Tensor, w: int) -> torch.Tensor:
    """(..., nb, W, p, q) -> out[r, k] = t[r + k - w, k] (zeros beyond)."""
    nb, W = t.shape[-4], t.shape[-3]
    tp = nn.functional.pad(t, (0, 0, 0, 0, 0, 0, w, w))
    return torch.stack([tp[..., k:k + nb, k, :, :] for k in range(W)],
                       dim=-3)


class BandAux(NamedTuple):
    """Static band-structure operands of :func:`flash_apply`.

    slab_col : (nb, W, ibs, ibs) -- slab_col[j, k] = S[rows j+k-w, cols j]
    mask_col : the support of S+I as 0/1 floats, in the same layout
    mask_row : (nb, W, ibs, ibs) -- mask_row[i, k] = the support at
               [rows i, cols i+k-w]
    sup_entries, sup_offs : mask_col's :class:`SupportLists` (what the
               apply kernel reads: :attr:`lists`), empty where ibs is not
               a multiple of TILE_N
    """
    slab_col: torch.Tensor
    mask_col: torch.Tensor
    mask_row: torch.Tensor
    sup_entries: torch.Tensor
    sup_offs: torch.Tensor

    @property
    def lists(self) -> SupportLists:
        return SupportLists(self.sup_entries, self.sup_offs)


def make_support(slab5: torch.Tensor, w: int,
                 dtype=torch.float32) -> torch.Tensor:
    """S+I support shared across edge features, column layout: 0/1
    (nb, W, ibs, ibs) from the (E, nb, W, ibs, ibs) slab."""
    ibs = slab5.shape[3]
    sup = slab5.abs().sum(0) > 1e-9
    sup[:, w] |= torch.eye(ibs, dtype=torch.bool, device=slab5.device)
    return sup.to(dtype)


def row_layout(t_col: torch.Tensor, w: int) -> torch.Tensor:
    """The row-window layout of a column-window tile set (nb, W, ibs, ibs):
    out[i, k] = t_col[i + k - w, 2w - k] (zeros off the matrix), the same
    (row, column) orientation inside each tile."""
    return _diag_win(torch.flip(t_col, dims=(-3,)), w)


def make_aux(slab5_e: torch.Tensor, support: torch.Tensor, w: int,
             lists: Optional[SupportLists] = None) -> BandAux:
    """BandAux for ONE edge feature's slab (nb, W, ibs, ibs); `support`
    from :func:`make_support`, `lists` its entry lists (built here if not
    given)."""
    if lists is None:
        lists = support_lists_or_empty(support)
    return BandAux(slab5_e.contiguous(), support, row_layout(support, w),
                   *lists)


def _auxes(slab5: torch.Tensor, w: int) -> list:
    """Per-edge-feature BandAux list (shared S+I support and its entry
    lists)."""
    support = make_support(slab5, w, slab5.dtype)
    lists = support_lists_or_empty(support)
    return [make_aux(slab5[e], support, w, lists)
            for e in range(slab5.shape[0])]


def slab5(gso) -> torch.Tensor:
    """A band-mode Gso's slab as (E, nb, W, ibs, ibs) (a view)."""
    E, nb, Wibs, ibs = gso.s_band.shape
    return gso.s_band.view(E, nb, Wibs // ibs, ibs, ibs)


class SupportLists(NamedTuple):
    """The S+I support of a column-layout mask (nb, W, ibs, ibs) as lists
    of entries, what the apply kernel's scores walk instead of the dense
    mask tiles. Chunk (j, h, k, pc) -- output columns j*ibs + 64 h .. + 64,
    window block k, rows pc*32 .. + 32 of it -- has id
    ((j * ibs/64 + h) * W + k) * ibs/32 + pc.

    entries : (n,) int16 -- each chunk's support as p * 64 + c (row p < 32,
              column c < 64 of the chunk), in row-major order, padded with
              -1 to a multiple of 8 entries (16 bytes)
    offsets : (n_chunks, 9) int32 -- offsets[i, g] is the index in entries
              of chunk i's first entry in rows 4g and up; offsets[i, 8] the
              end of its entries (before the padding)
    """
    entries: torch.Tensor
    offsets: torch.Tensor


def support_lists(mask_col: torch.Tensor) -> SupportLists:
    """:class:`SupportLists` of a 0/1 column-layout mask, on its device
    (ibs a multiple of 64). Deterministic: nonzero's row-major order."""
    nb, W, ibs, _ = mask_col.shape
    if ibs % TILE_N:
        raise ValueError(f"support_lists: ibs={ibs} is not a multiple of "
                         f"{TILE_N}")
    nh, cpb = ibs // TILE_N, ibs // APPLY_CHUNK
    n = nb * nh * W * cpb
    m = (mask_col.reshape(nb, W, cpb, APPLY_CHUNK, nh, TILE_N)
         .permute(0, 4, 1, 2, 3, 5).reshape(n, APPLY_CHUNK * TILE_N) != 0)
    counts = m.sum(1)
    padded = (counts + 7) // 8 * 8
    start = torch.cumsum(padded, 0) - padded
    chunk, idx = m.nonzero(as_tuple=True)
    rank = (torch.arange(len(idx), device=m.device)
            - (torch.cumsum(counts, 0) - counts)[chunk])
    entries = torch.full((max(int(padded.sum()), 8),), -1,
                         dtype=torch.int16, device=m.device)
    entries[start[chunk] + rank] = idx.to(torch.int16)
    groups = m.reshape(n, APPLY_CHUNK // 4, 4 * TILE_N).sum(2)
    offsets = torch.cat([torch.zeros_like(groups[:, :1]),
                         torch.cumsum(groups, 1)], 1) + start[:, None]
    return SupportLists(entries, offsets.to(torch.int32).contiguous())


def support_lists_or_empty(support: torch.Tensor) -> SupportLists:
    """:func:`support_lists` of a support, or empty lists where ibs is not
    a multiple of TILE_N (no kernel tiles it; the plain versions read the
    mask)."""
    if support.shape[-1] % TILE_N == 0:
        return support_lists(support)
    dev = support.device
    return SupportLists(torch.zeros(0, dtype=torch.int16, device=dev),
                        torch.zeros((0, 9), dtype=torch.int32, device=dev))


def band_auxes(gso) -> list:
    """The per-edge-feature BandAux of a band-mode Gso, built on first use
    on the Gso's device and cached on it (3 (nb, W, ibs, ibs) tensors a
    feature, 126 MB at N = 16384, and the support's entry lists).

    Built outside inference mode even when first asked for inside it (as
    ``InferenceEngine`` does at its first request): the cache outlives the
    request, and a later forward with grad enabled saves it for backward.
    """
    auxes = getattr(gso, "_band_auxes", None)
    if auxes is None:
        with torch.inference_mode(False):
            auxes = gso._band_auxes = _auxes(slab5(gso), gso.band_w)
    return auxes


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path, and the reference on the card)
# ---------------------------------------------------------------------------

def _win(vb: torch.Tensor, w: int) -> torch.Tensor:
    """(..., nb, ibs) -> (..., nb, W, ibs): out[r, k] = vb[r + k - w]
    (zeros beyond the ends)."""
    nb = vb.shape[-2]
    vp = nn.functional.pad(vb, (0, 0, w, w))
    return torch.stack([vp[..., k:k + nb, :] for k in range(2 * w + 1)],
                       dim=-2)


def _masked_scores(a2, a1, m, slope):
    e = nn.functional.leaky_relu(a2 + a1, negative_slope=slope)
    return e * m - (1.0 - m) * INFINITE


def stats_plain(a1x: torch.Tensor, a2x: torch.Tensor,
                mask_row: torch.Tensor, *, w: int, ibs: int,
                slope: float = 0.2):
    """(rowmax, rowsum), each (Q, Np): the max and the exp-sum of each
    row's masked scores over its column window. a1x, a2x (Q, Np);
    mask_row (nb, W, ibs, ibs). A row without support has every score
    -1e12 (window blocks off the matrix included, as the JAX kernel's
    clamped zero-mask tiles): rowmax -1e12, rowsum W*ibs. bf16 operands
    are upcast: the stats are f32 either way."""
    a1x, a2x, mask_row = (t.float() if t.dtype == torch.bfloat16 else t
                          for t in (a1x, a2x, mask_row))
    Q, Np = a1x.shape
    nb = Np // ibs
    a1w = _win(a1x.reshape(Q, nb, ibs), w)                # Q, nb, W, ibs
    a2b = a2x.reshape(Q, nb, 1, ibs, 1)
    e = _masked_scores(a2b, a1w[:, :, :, None, :], mask_row[None], slope)
    mx = e.amax(dim=(2, 4))                               # Q, nb, ibs
    sm = torch.exp(e - mx[:, :, None, :, None]).sum(dim=(2, 4))
    return mx.reshape(Q, Np), sm.reshape(Q, Np)


def apply_plain(a1x: torch.Tensor, a2x: torch.Tensor, v: torch.Tensor,
                rowmax: torch.Tensor, rowsum: torch.Tensor,
                slab_col: torch.Tensor, mask_col: torch.Tensor, *, w: int,
                ibs: int, with_s: bool = True,
                slope: float = 0.2) -> torch.Tensor:
    """y (Q, F, Np) = v @ (alpha (* S)) on the band, alpha re-derived from
    (a1x, a2x, rowmax, rowsum) as exp(score - rowmax) * (1 / rowsum) * m;
    v (Q, F, Np), the rest (Q, Np) and (nb, W, ibs, ibs). bf16 v (a1x,
    a2x, slab_col, mask_col too): computed in f32, y rounded to bf16 once."""
    if v.dtype == torch.bfloat16:
        return apply_plain(*(t.float() for t in (
            a1x, a2x, v, rowmax, rowsum, slab_col, mask_col)), w=w, ibs=ibs,
            with_s=with_s, slope=slope).to(v.dtype)
    Q, F, Np = v.shape
    nb = Np // ibs

    def rows(t):   # (Q, Np) -> (Q, nb, W, ibs, 1): the window's rows
        return _win(t.reshape(Q, nb, ibs), w)[..., None]

    e = _masked_scores(rows(a2x), a1x.reshape(Q, nb, 1, 1, ibs),
                       mask_col[None], slope)             # Q, nb, W, p, c
    # one reciprocal of rowsum a row, as the kernel
    rinv = 1.0 / rows(rowsum).clamp_min(1e-30)
    al = torch.exp(e - rows(rowmax)) * rinv * mask_col[None]
    coeff = al * slab_col[None] if with_s else al
    vw = _win(v.reshape(Q, F, nb, ibs), w)                # Q, F, nb, W, p
    y = torch.einsum("qjkpc,qfjkp->qfjc", coeff, vw)
    return y.reshape(Q, F, Np)


def _bwd_windowed(a1w, a2x, v, rowmax, rowsum, s_row, mask_row, gw,
                  slope):
    """The flash backward on windowed operands, per row block i of own
    rows over its column window k: a1w (Q, nb, W, ibs) and gw
    (Q, F, nb, W, ibs) the window's columns of a1 and g, s_row the slab in
    the row-window layout (None: alpha alone), the rest as in
    :func:`bwd_plain`. Returns (da2, da1p, dv) as there."""
    Q, F, Np = v.shape
    nb, ibs = a1w.shape[1], a1w.shape[3]
    pre = a2x.reshape(Q, nb, 1, ibs, 1) + a1w[:, :, :, None, :]
    m = mask_row[None]                                    # Q, nb, W, p, c
    e = nn.functional.leaky_relu(pre, negative_slope=slope)
    e = e * m - (1.0 - m) * INFINITE

    def rows(t):   # (Q, Np) -> (Q, nb, 1, ibs, 1)
        return t.reshape(Q, nb, 1, ibs, 1)
    # one reciprocal of rowsum a row, as the kernel
    rinv = 1.0 / rows(rowsum).clamp_min(1e-30)
    al = torch.exp(e - rows(rowmax)) * rinv * m
    dco = torch.einsum("qfip,qfikc->qikpc", v.reshape(Q, F, nb, ibs), gw)
    dal = dco if s_row is None else dco * s_row[None]
    delta = (al * dal).sum(dim=(2, 4))                    # Q, nb, p
    de = al * (dal - delta[:, :, None, :, None])
    dpre = de * m * torch.where(pre > 0, 1.0, slope)
    coeff = al if s_row is None else al * s_row[None]
    dv = torch.einsum("qfikc,qikpc->qfip", gw, coeff)
    return (dpre.sum(dim=(2, 4)).reshape(Q, Np), dpre.sum(dim=3),
            dv.reshape(Q, F, Np))


def bwd_plain(a1x: torch.Tensor, a2x: torch.Tensor, v: torch.Tensor,
              rowmax: torch.Tensor, rowsum: torch.Tensor,
              slab_col: torch.Tensor, mask_row: torch.Tensor,
              g: torch.Tensor, *, w: int, ibs: int, with_s: bool = True,
              slope: float = 0.2):
    """The backward of :func:`apply_plain` in (a1x, a2x, v) for the
    cotangent g (Q, F, Np), per row block over its column window:
    (da2 (Q, Np), da1p (Q, nb, W, ibs), dv (Q, F, Np)), where
    da1p[q, i, k] holds the sum over block i's rows at column block
    i + k - w (see :func:`fold_window_partials`). bf16 operands (the
    stats f32): computed in f32, da2 and da1p f32, dv rounded to bf16
    once (the JAX kernel on bf16 operands)."""
    if v.dtype == torch.bfloat16:
        da2, da1p, dv = bwd_plain(*(t.float() for t in (
            a1x, a2x, v, rowmax, rowsum, slab_col, mask_row, g)), w=w,
            ibs=ibs, with_s=with_s, slope=slope)
        return da2, da1p, dv.to(v.dtype)
    Q, F, Np = v.shape
    nb = Np // ibs
    return _bwd_windowed(
        _win(a1x.reshape(Q, nb, ibs), w), a2x, v, rowmax, rowsum,
        row_layout(slab_col, w) if with_s else None, mask_row,
        _win(g.reshape(Q, F, nb, ibs), w), slope)


def fold_window_partials(da1p: torch.Tensor, w: int) -> torch.Tensor:
    """(Q, nb, W, ibs) window partials -> d_a1x (Q, nb*ibs):
    d_a1x[column block j] = sum_k da1p[j + w - k, k] (the JAX package's
    fold, attention_flash.py:_bwd_call)."""
    Q, nb, W, ibs = da1p.shape
    dpp = nn.functional.pad(da1p, (0, 0, 0, 0, w, w))
    da1 = sum(dpp[:, 2 * w - k:2 * w - k + nb, k] for k in range(W))
    return da1.reshape(Q, nb * ibs)


def fold_ext_partials(da1p: torch.Tensor) -> torch.Tensor:
    """(Q, nbl, W, ibs) window partials of :func:`bwd_ext_call` -> d_a1 of
    the shard's halo-extended columns (Q, (nbl + W - 1) * ibs): ext column
    block j + k gathers da1p[j, k], k in order (the JAX package's fold,
    parallel/attention.py:local_bwd). ``parallel.mesh.halo_fold`` then
    returns the halo columns to the shards that own them."""
    Q, nbl, W, ibs = da1p.shape
    da1 = da1p.new_zeros((Q, nbl + W - 1, ibs))
    for k in range(W):
        da1[:, k:k + nbl] += da1p[:, :, k]
    return da1.reshape(Q, (nbl + W - 1) * ibs)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_band(name: str, Np: int, w: int, ibs: int, **tiles) -> int:
    if Np % ibs:
        raise ValueError(f"{name}: Np={Np} is not a multiple of ibs={ibs}")
    nb = Np // ibs
    for arg, t in tiles.items():
        if tuple(t.shape) != (nb, 2 * w + 1, ibs, ibs):
            raise ValueError(f"{name}: {arg} {tuple(t.shape)} does not fit "
                             f"nb={nb}, w={w}, ibs={ibs}")
    return nb


def _check_tile(name: str, ibs: int) -> None:
    if ibs % TILE_N:
        raise ValueError(f"{name}: the CUDA kernel needs ibs a multiple of "
                         f"{TILE_N}, got {ibs}")


def stats_call(a1x: torch.Tensor, a2x: torch.Tensor, mask_row: torch.Tensor,
               *, w: int, ibs: int, slope: float = 0.2):
    """Row softmax stats of the masked band scores: (rowmax, rowsum), each
    (Q, Np) in f32, from a1x, a2x (Q, Np) and mask_row (nb, W, ibs, ibs),
    all three f32 or all bf16.

    CUDA kernel: ``attn_stats_kernel<false>`` in
    kernels/csrc/attention_flash.cu (the scores on each row's support,
    compacted from mask_row on the card; 4 signal rows at a time over lanes
    on the entries), in bf16 ``attn_stats_bf16_kernel<false>`` (the mask
    and a1 staged in bf16 by 16-byte copies, the lists compacted in shared
    memory, each lane walking a row's list for one signal row), replacing
    the Pallas kernel of the JAX package's
    ``ops/attention_flash.py:_stats_call``. The window (2w+1)*ibs must fit
    the kernel's int16 positions and shared memory (it raises past ~11,600
    columns).
    """
    Q, Np = a1x.shape
    if tuple(a2x.shape) != (Q, Np):
        raise ValueError(f"stats_call: a1x {tuple(a1x.shape)} vs a2x "
                         f"{tuple(a2x.shape)}")
    _check_band("stats_call", Np, w, ibs, mask_row=mask_row)
    if not kernels.on_cuda("stats_call", a1x, a2x, mask_row) and \
            kernels.needs_grad(a1x, a2x):
        return stats_plain(a1x, a2x, mask_row, w=w, ibs=ibs, slope=slope)
    return _ATTN_STATS(a1x, a2x, mask_row, w, ibs, slope)


stats_call.launches = 0


def _lists_ptrs(name: str, lists: Optional[SupportLists],
                mask_col: torch.Tensor):
    """The apply launchers' sup_entries, sup_offs: the pointers of
    mask_col's entry lists, built once with the band structure; raises if
    they are missing or do not fit mask_col."""
    if lists is None or any(t is None for t in lists):
        raise ValueError(f"{name}: the kernel reads the support's entry "
                         "lists: pass lists=support_lists(mask_col), built "
                         "once with the band structure (BandAux.lists)")
    nb, W, ibs, _ = mask_col.shape
    n = nb * (ibs // TILE_N) * W * (ibs // APPLY_CHUNK)
    if tuple(lists.offsets.shape) != (n, 9):
        raise ValueError(f"{name}: lists.offsets "
                         f"{tuple(lists.offsets.shape)} do not fit mask_col "
                         f"{tuple(mask_col.shape)}: expected ({n}, 9)")
    kernels.on_cuda(name, mask_col, *lists)
    kernels.check_inputs(name, entries=(lists.entries, torch.int16),
                         offsets=(lists.offsets, torch.int32))
    return lists.entries.data_ptr(), lists.offsets.data_ptr()


def apply_call(a1x: torch.Tensor, a2x: torch.Tensor, v: torch.Tensor,
               rowmax: torch.Tensor, rowsum: torch.Tensor,
               slab_col: torch.Tensor, mask_col: torch.Tensor, *, w: int,
               ibs: int, with_s: bool = True, slope: float = 0.2,
               lists: Optional[SupportLists] = None) -> torch.Tensor:
    """y (Q, F, Np) = v @ (alpha (* S)) on the band, alpha recomputed tile
    by tile from a1x, a2x and the stats of :func:`stats_call`; y in v's
    dtype (a1x, a2x, v, slab_col and mask_col all f32 or all bf16, the
    stats f32). lists: mask_col's :func:`support_lists`, on whose entries
    the kernel runs the scores; required on CUDA (BandAux.lists), unused by
    the plain version.

    CUDA kernel: ``attn_apply_kernel<false, G>`` in
    kernels/csrc/attention_flash.cu (``attn_apply_mma_kernel<false, G>`` in
    bf16: tensor cores), replacing the Pallas kernel of the JAX package's
    ``ops/attention_flash.py:_apply_call``.
    """
    Q, F, Np = v.shape
    for arg, t in (("a1x", a1x), ("a2x", a2x), ("rowmax", rowmax),
                   ("rowsum", rowsum)):
        if tuple(t.shape) != (Q, Np):
            raise ValueError(f"apply_call: {arg} {tuple(t.shape)} does not "
                             f"fit v {tuple(v.shape)}")
    _check_band("apply_call", Np, w, ibs, slab_col=slab_col,
                mask_col=mask_col)
    operands = (a1x, a2x, v, rowmax, rowsum, slab_col, mask_col)
    if not kernels.on_cuda("apply_call", *operands) and kernels.needs_grad(
            a1x, a2x, v):
        return apply_plain(*operands, w=w, ibs=ibs, with_s=with_s,
                           slope=slope)
    entries, offsets = (None, None) if lists is None else lists
    return _ATTN_APPLY(*operands, entries, offsets, w, ibs, with_s, slope)


apply_call.launches = 0


# ---------------------------------------------------------------------------
# The ops of stats and apply (torch.library): CPU = the plain version,
# CUDA = the kernel (either io dtype)
# ---------------------------------------------------------------------------

_LIB = torch.library.Library("gnt", "FRAGMENT")
_LIB.define("attn_stats(Tensor a1x, Tensor a2x, Tensor mask_row, int w, "
            "int ibs, float slope) -> (Tensor, Tensor)")
_LIB.define("attn_apply(Tensor a1x, Tensor a2x, Tensor v, Tensor rowmax, "
            "Tensor rowsum, Tensor slab_col, Tensor mask_col, "
            "Tensor? sup_entries, Tensor? sup_offs, int w, int ibs, "
            "bool with_s, float slope) -> Tensor")


def _attn_stats_cpu(a1x, a2x, mask_row, w, ibs, slope):
    kernels.OP_CALLS["stats_call", a1x.dtype] += 1
    return stats_plain(a1x, a2x, mask_row, w=w, ibs=ibs, slope=slope)


def _attn_stats_cuda(a1x, a2x, mask_row, w, ibs, slope):
    dt = kernels.io_dtype("stats_call", a1x)
    kernels.check_inputs("stats_call", a1x=(a1x, dt), a2x=(a2x, dt),
                         mask_row=(mask_row, dt))
    _check_tile("stats_call", ibs)
    Q, Np = a1x.shape
    f32 = torch.float32
    rowmax = torch.empty((Q, Np), dtype=f32, device=a1x.device)
    rowsum = torch.empty((Q, Np), dtype=f32, device=a1x.device)
    if Q == 0:
        return rowmax, rowsum
    err = kernels.entry("gnt_attn_stats", dt)(
        a1x.data_ptr(), a2x.data_ptr(), mask_row.data_ptr(),
        rowmax.data_ptr(), rowsum.data_ptr(), Q, Np, Np // ibs, w, ibs, slope,
        kernels.stream())
    kernels.check(err, "stats_call")
    stats_call.launches += 1
    kernels.OP_CALLS["stats_call", dt] += 1
    return rowmax, rowsum


def _attn_apply_cpu(a1x, a2x, v, rowmax, rowsum, slab_col, mask_col,
                    sup_entries, sup_offs, w, ibs, with_s, slope):
    kernels.OP_CALLS["apply_call", v.dtype] += 1
    return apply_plain(a1x, a2x, v, rowmax, rowsum, slab_col, mask_col, w=w,
                       ibs=ibs, with_s=with_s, slope=slope)


def _attn_apply_cuda(a1x, a2x, v, rowmax, rowsum, slab_col, mask_col,
                     sup_entries, sup_offs, w, ibs, with_s, slope):
    dt, f32 = kernels.io_dtype("apply_call", v), torch.float32
    kernels.check_inputs("apply_call", a1x=(a1x, dt), a2x=(a2x, dt),
                         v=(v, dt), rowmax=(rowmax, f32),
                         rowsum=(rowsum, f32), slab_col=(slab_col, dt),
                         mask_col=(mask_col, dt))
    _check_tile("apply_call", ibs)
    sup = _lists_ptrs("apply_call", SupportLists(sup_entries, sup_offs),
                      mask_col)
    Q, F, Np = v.shape
    y = torch.empty((Q, F, Np), dtype=dt, device=v.device)
    if Q == 0 or F == 0:
        return y
    err = kernels.entry("gnt_attn_apply", dt)(
        a1x.data_ptr(), a2x.data_ptr(), v.data_ptr(), rowmax.data_ptr(),
        rowsum.data_ptr(), slab_col.data_ptr(), *sup, y.data_ptr(), Q, F,
        Np, Np // ibs, w, ibs, int(with_s), slope, kernels.stream())
    kernels.check(err, "apply_call")
    apply_call.launches += 1
    kernels.OP_CALLS["apply_call", dt] += 1
    return y


_LIB.impl("attn_stats", _attn_stats_cpu, "CPU")
_LIB.impl("attn_stats", _attn_stats_cuda, "CUDA")
_LIB.impl("attn_apply", _attn_apply_cpu, "CPU")
_LIB.impl("attn_apply", _attn_apply_cuda, "CUDA")


@torch.library.register_fake("gnt::attn_stats", lib=_LIB)
def _(a1x, a2x, mask_row, w, ibs, slope):
    return (a1x.new_empty(a1x.shape, dtype=torch.float32),
            a1x.new_empty(a1x.shape, dtype=torch.float32))


@torch.library.register_fake("gnt::attn_apply", lib=_LIB)
def _(a1x, a2x, v, rowmax, rowsum, slab_col, mask_col, sup_entries,
      sup_offs, w, ibs, with_s, slope):
    return torch.empty_like(v)


# Flop counts over every score of the window tiles, Q * nb * W * ibs^2 (the
# function the JAX kernels compute tile by tile; the CUDA kernels run the
# scores on the support only, so they do fewer): stats 5 a score (the
# pre-activation add, the LeakyReLU multiply, the max, the subtraction and
# the sum's add; the exp is a transcendental, not counted), apply 2F + 6 a
# score (the pre-activation add and LeakyReLU multiply, the subtraction,
# the reciprocal's and the mask's multiplies, the slab's multiply, and a
# multiply-add for each of the F features).
@register_flop_formula(torch.ops.gnt.attn_stats)
def _(a1x_shape, a2x_shape, mask_row_shape, *args, out_shape=None,
      **kwargs) -> int:
    return 5 * a1x_shape[0] * math.prod(mask_row_shape)


@register_flop_formula(torch.ops.gnt.attn_apply)
def _(a1x_shape, a2x_shape, v_shape, rowmax_shape, rowsum_shape,
      slab_col_shape, *args, out_shape=None, **kwargs) -> int:
    Q, F, _ = v_shape
    return (2 * F + 6) * Q * math.prod(slab_col_shape)


_ATTN_STATS = torch.ops.gnt.attn_stats.default
_ATTN_APPLY = torch.ops.gnt.attn_apply.default



# A block's shared memory on the card (attn_bwd_kernel's layout is
# bwd_layout in attention_flash.cu; gnt_attn_bwd_smem_bytes gives its size)
_BLOCK_SMEM_BYTES = 227 * 1024


# The most features the bf16 backward takes (attn_bwd_mma_kernel keeps a
# warp's dv^T in registers)
BWD_BF16_MAX_F = 64


def bwd_bf16_smem_bytes(F: int, W: int, ibs: int) -> int:
    """The dynamic shared memory of attn_bwd_mma_kernel at (F, W, ibs), in
    bytes: bwd_mma_layout in attention_flash.cu (whose
    gnt_attn_bwd_smem_bytes_bf16 gives the same). The 64-row tile's v and
    dv of its 2 signal rows, a ring of 3 window chunks (the mask and slab
    once, g and a1 for each signal row; bf16 rows padded by 8), the warps'
    da1 column sums twice, the da1 partials of both signal rows and the
    chunk lists."""
    FP = -(-F // 16) * 16
    nch = W * (ibs // 64)
    tile = 2 * 2 * FP * 72
    stage = 2 * (2 * 64 * 72 + 2 * FP * 72 + 2 * 64)
    return (2 * tile + 3 * stage + 4 * 2 * 8 * 64 + 4 * 2 * W * ibs
            + 4 * (2 * nch + 1))


def _check_bwd_smem(name: str, w: int, ibs: int, F: int,
                    dtype=torch.float32) -> None:
    """Raise unless the backward kernel of `dtype` (attn_bwd_kernel, or
    attn_bwd_mma_kernel in bf16) takes (w, ibs, F): its shared memory fits
    a block, and in bf16 F is at most BWD_BF16_MAX_F."""
    if dtype == torch.bfloat16:
        if F > BWD_BF16_MAX_F:
            raise ValueError(f"{name}: the bf16 kernel takes F <= "
                             f"{BWD_BF16_MAX_F} features, got {F}")
        need = bwd_bf16_smem_bytes(F, 2 * w + 1, ibs)
    else:
        need = kernels.entry("gnt_attn_bwd_smem_bytes", dtype)(
            F, 2 * w + 1, ibs)
    if need > _BLOCK_SMEM_BYTES:
        raise ValueError(f"{name}: w={w}, ibs={ibs}, F={F} need {need} bytes "
                         f"of shared memory a block, above "
                         f"{_BLOCK_SMEM_BYTES}")


def bwd_call(a1x: torch.Tensor, a2x: torch.Tensor, v: torch.Tensor,
             rowmax: torch.Tensor, rowsum: torch.Tensor,
             slab_col: torch.Tensor, mask_row: torch.Tensor, g: torch.Tensor,
             *, w: int, ibs: int, with_s: bool = True, slope: float = 0.2):
    """The flash backward of :func:`apply_call` for the cotangent g
    (Q, F, Np): (da2 (Q, Np), da1p (Q, nb, W, ibs) window partials, dv
    (Q, F, Np)); fold da1p with :func:`fold_window_partials`. S is read in
    its column layout (slab_col) at the mirrored index of the row layout,
    the support in the row layout (mask_row). a1x, a2x, v, slab_col,
    mask_row and g all f32 or all bf16 (the stats f32); da2 and da1p are
    f32, dv in v's dtype.

    CUDA kernel: ``attn_bwd_kernel`` in kernels/csrc/attention_flash.cu
    (one signal row and row block a block), in bf16
    ``attn_bwd_mma_kernel<false, NF>`` (tensor cores, F <= 64; a block
    serves two signal rows of a row block in 64-row tiles, staging each
    window chunk's mask and slab once for both; its shared memory is
    :func:`bwd_bf16_smem_bytes`, checked before the launch), replacing the
    Pallas kernel of the JAX package's
    ``ops/attention_flash.py:_bwd_call``.
    """
    Q, F, Np = v.shape
    if tuple(g.shape) != (Q, F, Np):
        raise ValueError(f"bwd_call: g {tuple(g.shape)} does not fit v "
                         f"{tuple(v.shape)}")
    for arg, t in (("a1x", a1x), ("a2x", a2x), ("rowmax", rowmax),
                   ("rowsum", rowsum)):
        if tuple(t.shape) != (Q, Np):
            raise ValueError(f"bwd_call: {arg} {tuple(t.shape)} does not "
                             f"fit v {tuple(v.shape)}")
    nb = _check_band("bwd_call", Np, w, ibs, slab_col=slab_col,
                     mask_row=mask_row)
    operands = (a1x, a2x, v, rowmax, rowsum, slab_col, mask_row, g)
    if not kernels.on_cuda("bwd_call", *operands):
        kernels.OP_CALLS["bwd_call", v.dtype] += 1
        return bwd_plain(*operands, w=w, ibs=ibs, with_s=with_s, slope=slope)
    dt, f32 = kernels.io_dtype("bwd_call", v), torch.float32
    kernels.check_inputs("bwd_call", a1x=(a1x, dt), a2x=(a2x, dt),
                         v=(v, dt), rowmax=(rowmax, f32),
                         rowsum=(rowsum, f32), slab_col=(slab_col, dt),
                         mask_row=(mask_row, dt), g=(g, dt))
    _check_tile("bwd_call", ibs)
    _check_bwd_smem("bwd_call", w, ibs, F, dt)
    W = 2 * w + 1
    da2 = torch.empty((Q, Np), dtype=f32, device=v.device)
    da1p = torch.empty((Q, nb, W, ibs), dtype=f32, device=v.device)
    dv = torch.empty((Q, F, Np), dtype=dt, device=v.device)
    if Q == 0 or F == 0:
        return da2.zero_(), da1p.zero_(), dv
    err = kernels.entry("gnt_attn_bwd", dt)(
        g.data_ptr(), a1x.data_ptr(), a2x.data_ptr(), v.data_ptr(),
        rowmax.data_ptr(), rowsum.data_ptr(), slab_col.data_ptr(),
        mask_row.data_ptr(), da2.data_ptr(), da1p.data_ptr(), dv.data_ptr(),
        Q, F, Np, nb, w, ibs, int(with_s), slope, kernels.stream())
    kernels.check(err, "bwd_call")
    bwd_call.launches += 1
    kernels.OP_CALLS["bwd_call", dt] += 1
    return da2, da1p, dv


bwd_call.launches = 0


# ---------------------------------------------------------------------------
# Ext-layout calls: the shard-local step of parallel.attention. The
# operands read through the window carry w halo blocks a side (row length
# Np + 2*w*ibs, zero past the global ends), so window block k of own block
# j is ext block j + k, never clipped. Np is the shard's own width.
# ---------------------------------------------------------------------------

def _ext_win(t: torch.Tensor, nbl: int, W: int) -> torch.Tensor:
    """(..., nbl + W - 1, ibs) -> (..., nbl, W, ibs): out[j, k] = t[j + k]."""
    return torch.stack([t[..., k:k + nbl, :] for k in range(W)], dim=-2)


def stats_ext_plain(a1_ext: torch.Tensor, a2x: torch.Tensor,
                    mask_row: torch.Tensor, *, w: int, ibs: int,
                    slope: float = 0.2):
    """(rowmax, rowsum), each (Q, Np), of the shard's own rows over their
    whole column window. a1_ext (Q, Np + 2*w*ibs) halo-extended, a2x
    (Q, Np) own, mask_row (nbl, W, ibs, ibs) in global-column layout.
    bf16 operands are upcast: the stats are f32 either way."""
    a1_ext, a2x, mask_row = (t.float() if t.dtype == torch.bfloat16 else t
                             for t in (a1_ext, a2x, mask_row))
    Q, Np = a2x.shape
    nbl, W = Np // ibs, 2 * w + 1
    a1w = _ext_win(a1_ext.reshape(Q, nbl + 2 * w, ibs), nbl, W)
    e = _masked_scores(a2x.reshape(Q, nbl, 1, ibs, 1),
                       a1w[:, :, :, None, :], mask_row[None], slope)
    mx = e.amax(dim=(2, 4))                               # Q, nbl, ibs
    sm = torch.exp(e - mx[:, :, None, :, None]).sum(dim=(2, 4))
    return mx.reshape(Q, Np), sm.reshape(Q, Np)


def apply_ext_plain(a1x: torch.Tensor, a2_ext: torch.Tensor,
                    v_ext: torch.Tensor, mx_ext: torch.Tensor,
                    sm_ext: torch.Tensor, slab_col: torch.Tensor,
                    mask_col: torch.Tensor, *, w: int, ibs: int,
                    with_s: bool = True, slope: float = 0.2,
                    lists: Optional[SupportLists] = None) -> torch.Tensor:
    """y (Q, F, Np) for the shard's own output columns: alpha re-derived
    from a1x (Q, Np) own and the halo-extended rows a2_ext, mx_ext, sm_ext
    (Q, Np + 2*w*ibs), aggregated over v_ext (Q, F, Np + 2*w*ibs);
    slab_col, mask_col (nbl, W, ibs, ibs). lists, the kernel's entry
    lists, is not read (mask_col is): it is taken so that the sharded
    schedule calls this and :func:`apply_ext_call` alike. bf16 v_ext (a1x,
    a2_ext, slab_col, mask_col too): computed in f32, y rounded to bf16
    once."""
    if v_ext.dtype == torch.bfloat16:
        return apply_ext_plain(*(t.float() for t in (
            a1x, a2_ext, v_ext, mx_ext, sm_ext, slab_col, mask_col)), w=w,
            ibs=ibs, with_s=with_s, slope=slope).to(v_ext.dtype)
    Q, Np = a1x.shape
    F = v_ext.shape[1]
    nbl, W = Np // ibs, 2 * w + 1

    def rows(t):   # (Q, Npe) -> (Q, nbl, W, ibs, 1): the window's rows
        return _ext_win(t.reshape(Q, nbl + 2 * w, ibs), nbl, W)[..., None]

    e = _masked_scores(rows(a2_ext), a1x.reshape(Q, nbl, 1, 1, ibs),
                       mask_col[None], slope)             # Q, nbl, W, p, c
    # one reciprocal of rowsum a row, as the kernel; the stats are zero
    # past the global ends, where mask_col is 0: the guard keeps alpha 0
    # there (exp(-1e12) * 1e30 * 0), not 0/0
    rinv = 1.0 / rows(sm_ext).clamp_min(1e-30)
    al = torch.exp(e - rows(mx_ext)) * rinv * mask_col[None]
    coeff = al * slab_col[None] if with_s else al
    vw = _ext_win(v_ext.reshape(Q, F, nbl + 2 * w, ibs), nbl, W)
    y = torch.einsum("qjkpc,qfjkp->qfjc", coeff, vw)
    return y.reshape(Q, F, Np)


def ext_row_layout(slab_col_ext: torch.Tensor, w: int) -> torch.Tensor:
    """The row-window layout (nbl, W, ibs, ibs) of a shard's own rows from
    its halo-extended column slab (nbl + 2w, W, ibs, ibs):
    out[i, k] = slab_col_ext[i + k, 2w - k], S at (own row block i, ext
    column block i + k)."""
    W = 2 * w + 1
    nbl = slab_col_ext.shape[0] - 2 * w
    return torch.stack([slab_col_ext[k:k + nbl, 2 * w - k] for k in range(W)],
                       dim=1)


def bwd_ext_plain(a1_ext: torch.Tensor, a2x: torch.Tensor, v: torch.Tensor,
                  rowmax: torch.Tensor, rowsum: torch.Tensor,
                  slab_col_ext: torch.Tensor, mask_row: torch.Tensor,
                  g_ext: torch.Tensor, *, w: int, ibs: int,
                  with_s: bool = True, slope: float = 0.2):
    """The flash backward for one shard's own rows: a1_ext (Q, Np + 2*w*ibs)
    and the cotangent g_ext (Q, F, Np + 2*w*ibs) halo-extended; a2x,
    rowmax, rowsum (Q, Np) and v (Q, F, Np) own; slab_col_ext
    (nbl + 2w, W, ibs, ibs) the halo-extended column slab; mask_row
    (nbl, W, ibs, ibs). Returns (da2 (Q, Np), da1p (Q, nbl, W, ibs) with
    da1p[q, i, k] at ext column block i + k (:func:`fold_ext_partials`),
    dv (Q, F, Np)). bf16 operands (the stats f32): computed in f32, da2
    and da1p f32, dv rounded to bf16 once."""
    if v.dtype == torch.bfloat16:
        da2, da1p, dv = bwd_ext_plain(*(t.float() for t in (
            a1_ext, a2x, v, rowmax, rowsum, slab_col_ext, mask_row, g_ext)),
            w=w, ibs=ibs, with_s=with_s, slope=slope)
        return da2, da1p, dv.to(v.dtype)
    Q, F, Np = v.shape
    nbl, W = Np // ibs, 2 * w + 1
    return _bwd_windowed(
        _ext_win(a1_ext.reshape(Q, nbl + 2 * w, ibs), nbl, W), a2x, v,
        rowmax, rowsum, ext_row_layout(slab_col_ext, w) if with_s else None,
        mask_row, _ext_win(g_ext.reshape(Q, F, nbl + 2 * w, ibs), nbl, W),
        slope)


def _check_shapes(name: str, **expected) -> None:
    """Raise unless each ``arg=(tensor, shape)`` has that shape."""
    for arg, (t, shape) in expected.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} {tuple(t.shape)}, expected "
                             f"{shape} (halo-extended: Np + 2*w*ibs)")


def _check_ext_kernel(name: str, nbl: int, w: int, ibs: int) -> None:
    _check_tile(name, ibs)
    if w > nbl:
        raise ValueError(f"{name}: the halo of w={w} blocks is wider than "
                         f"the shard's nbl={nbl} blocks (not a ring)")


def stats_ext_call(a1_ext: torch.Tensor, a2x: torch.Tensor,
                   mask_row: torch.Tensor, *, w: int, ibs: int,
                   slope: float = 0.2):
    """Row softmax stats (rowmax, rowsum), each (Q, Np) in f32, of one
    shard's own rows: a1_ext (Q, Np + 2*w*ibs) halo-extended, a2x (Q, Np)
    own, mask_row (nbl, W, ibs, ibs), all three f32 or all bf16.

    CUDA kernel: ``attn_stats_kernel<true>`` in
    kernels/csrc/attention_flash.cu, in bf16 ``attn_stats_bf16_kernel<true>``
    (:func:`stats_call`'s kernels on the ext addressing: a row gets the
    global call's bits), replacing the Pallas kernel of the JAX package's
    ``ops/attention_flash.py:_stats_ext_call``.
    """
    Q, Np = a2x.shape
    nbl = _check_band("stats_ext_call", Np, w, ibs, mask_row=mask_row)
    _check_shapes("stats_ext_call",
                  a1_ext=(a1_ext, (Q, Np + 2 * w * ibs)))
    if not kernels.on_cuda("stats_ext_call", a1_ext, a2x, mask_row):
        kernels.OP_CALLS["stats_ext_call", a1_ext.dtype] += 1
        return stats_ext_plain(a1_ext, a2x, mask_row, w=w, ibs=ibs,
                               slope=slope)
    dt, f32 = kernels.io_dtype("stats_ext_call", a1_ext), torch.float32
    kernels.check_inputs("stats_ext_call", a1_ext=(a1_ext, dt),
                         a2x=(a2x, dt), mask_row=(mask_row, dt))
    _check_ext_kernel("stats_ext_call", nbl, w, ibs)
    rowmax = torch.empty((Q, Np), dtype=f32, device=a2x.device)
    rowsum = torch.empty((Q, Np), dtype=f32, device=a2x.device)
    if Q == 0:
        return rowmax, rowsum
    err = kernels.entry("gnt_attn_stats_ext", dt)(
        a1_ext.data_ptr(), a2x.data_ptr(), mask_row.data_ptr(),
        rowmax.data_ptr(), rowsum.data_ptr(), Q, Np, nbl, w, ibs, slope,
        kernels.stream())
    kernels.check(err, "stats_ext_call")
    stats_ext_call.launches += 1
    kernels.OP_CALLS["stats_ext_call", dt] += 1
    return rowmax, rowsum


stats_ext_call.launches = 0


def apply_ext_call(a1x: torch.Tensor, a2_ext: torch.Tensor,
                   v_ext: torch.Tensor, mx_ext: torch.Tensor,
                   sm_ext: torch.Tensor, slab_col: torch.Tensor,
                   mask_col: torch.Tensor, *, w: int, ibs: int,
                   with_s: bool = True, slope: float = 0.2,
                   lists: Optional[SupportLists] = None) -> torch.Tensor:
    """y (Q, F, Np) = v @ (alpha (* S)) for one shard's own output columns,
    in v_ext's dtype: a1x (Q, Np) own; a2_ext, mx_ext, sm_ext
    (Q, Np + 2*w*ibs) and v_ext (Q, F, Np + 2*w*ibs) halo-extended rows;
    slab_col, mask_col (nbl, W, ibs, ibs); lists as in :func:`apply_call`.
    a1x, a2_ext, v_ext, slab_col and mask_col all f32 or all bf16, the
    stats f32.

    CUDA kernel: ``attn_apply_kernel<true, G>`` in
    kernels/csrc/attention_flash.cu (``attn_apply_mma_kernel<true, G>`` in
    bf16: tensor cores), replacing the Pallas kernel of the JAX package's
    ``ops/attention_flash.py:_apply_ext_call``.
    """
    Q, Np = a1x.shape
    F = v_ext.shape[1] if v_ext.dim() == 3 else -1
    nbl = _check_band("apply_ext_call", Np, w, ibs, slab_col=slab_col,
                      mask_col=mask_col)
    Npe = Np + 2 * w * ibs
    _check_shapes("apply_ext_call", a2_ext=(a2_ext, (Q, Npe)),
                  v_ext=(v_ext, (Q, F, Npe)), mx_ext=(mx_ext, (Q, Npe)),
                  sm_ext=(sm_ext, (Q, Npe)))
    operands = (a1x, a2_ext, v_ext, mx_ext, sm_ext, slab_col, mask_col)
    if not kernels.on_cuda("apply_ext_call", *operands):
        kernels.OP_CALLS["apply_ext_call", v_ext.dtype] += 1
        return apply_ext_plain(*operands, w=w, ibs=ibs, with_s=with_s,
                               slope=slope)
    dt, f32 = kernels.io_dtype("apply_ext_call", v_ext), torch.float32
    kernels.check_inputs("apply_ext_call", a1x=(a1x, dt),
                         a2_ext=(a2_ext, dt), v_ext=(v_ext, dt),
                         mx_ext=(mx_ext, f32), sm_ext=(sm_ext, f32),
                         slab_col=(slab_col, dt), mask_col=(mask_col, dt))
    _check_ext_kernel("apply_ext_call", nbl, w, ibs)
    sup = _lists_ptrs("apply_ext_call", lists, mask_col)
    y = torch.empty((Q, F, Np), dtype=dt, device=a1x.device)
    if Q == 0 or F == 0:
        return y
    err = kernels.entry("gnt_attn_apply_ext", dt)(
        *(t.data_ptr() for t in operands[:6]), *sup, y.data_ptr(), Q, F, Np,
        nbl, w, ibs, int(with_s), slope, kernels.stream())
    kernels.check(err, "apply_ext_call")
    apply_ext_call.launches += 1
    kernels.OP_CALLS["apply_ext_call", dt] += 1
    return y


apply_ext_call.launches = 0


def bwd_ext_call(a1_ext: torch.Tensor, a2x: torch.Tensor, v: torch.Tensor,
                 rowmax: torch.Tensor, rowsum: torch.Tensor,
                 slab_col_ext: torch.Tensor, mask_row: torch.Tensor,
                 g_ext: torch.Tensor, *, w: int, ibs: int,
                 with_s: bool = True, slope: float = 0.2):
    """The flash backward of :func:`apply_ext_call`'s schedule for one
    shard's own rows: (da2 (Q, Np), da1p (Q, nbl, W, ibs) window partials
    in ext column coordinates, dv (Q, F, Np)) from a1_ext and the
    cotangent g_ext halo-extended, a2x, v and the stats own, the
    halo-extended column slab (nbl + 2w, W, ibs, ibs) and mask_row
    (nbl, W, ibs, ibs); see :func:`bwd_ext_plain`. a1_ext, a2x, v,
    slab_col_ext, mask_row and g_ext all f32 or all bf16 (the stats f32);
    da2 and da1p are f32, dv in v's dtype.

    CUDA kernel: ``attn_bwd_kernel<true>`` in
    kernels/csrc/attention_flash.cu, in bf16 ``attn_bwd_mma_kernel<true,
    NF>`` (:func:`bwd_call`'s kernels on the ext addressing: a shard's da2
    and dv are the global call's rows bit for bit), replacing the Pallas
    kernel of the JAX package's ``ops/attention_flash.py:_bwd_ext_call``.
    """
    Q, F, Np = v.shape
    nbl = _check_band("bwd_ext_call", Np, w, ibs, mask_row=mask_row)
    Npe = Np + 2 * w * ibs
    W = 2 * w + 1
    _check_shapes("bwd_ext_call", a1_ext=(a1_ext, (Q, Npe)),
                  a2x=(a2x, (Q, Np)), rowmax=(rowmax, (Q, Np)),
                  rowsum=(rowsum, (Q, Np)), g_ext=(g_ext, (Q, F, Npe)),
                  slab_col_ext=(slab_col_ext, (nbl + 2 * w, W, ibs, ibs)))
    operands = (a1_ext, a2x, v, rowmax, rowsum, slab_col_ext, mask_row,
                g_ext)
    if not kernels.on_cuda("bwd_ext_call", *operands):
        kernels.OP_CALLS["bwd_ext_call", v.dtype] += 1
        return bwd_ext_plain(*operands, w=w, ibs=ibs, with_s=with_s,
                             slope=slope)
    dt, f32 = kernels.io_dtype("bwd_ext_call", v), torch.float32
    kernels.check_inputs("bwd_ext_call", a1_ext=(a1_ext, dt),
                         a2x=(a2x, dt), v=(v, dt), rowmax=(rowmax, f32),
                         rowsum=(rowsum, f32),
                         slab_col_ext=(slab_col_ext, dt),
                         mask_row=(mask_row, dt), g_ext=(g_ext, dt))
    _check_ext_kernel("bwd_ext_call", nbl, w, ibs)
    _check_bwd_smem("bwd_ext_call", w, ibs, F, dt)
    da2 = torch.empty((Q, Np), dtype=f32, device=v.device)
    da1p = torch.empty((Q, nbl, W, ibs), dtype=f32, device=v.device)
    dv = torch.empty((Q, F, Np), dtype=dt, device=v.device)
    if Q == 0 or F == 0:
        return da2.zero_(), da1p.zero_(), dv
    err = kernels.entry("gnt_attn_bwd_ext", dt)(
        g_ext.data_ptr(), a1_ext.data_ptr(), a2x.data_ptr(), v.data_ptr(),
        rowmax.data_ptr(), rowsum.data_ptr(), slab_col_ext.data_ptr(),
        mask_row.data_ptr(), da2.data_ptr(), da1p.data_ptr(), dv.data_ptr(),
        Q, F, Np, nbl, w, ibs, int(with_s), slope, kernels.stream())
    kernels.check(err, "bwd_ext_call")
    bwd_ext_call.launches += 1
    kernels.OP_CALLS["bwd_ext_call", dt] += 1
    return da2, da1p, dv


bwd_ext_call.launches = 0


KERNEL_WRAPPERS = (stats_call, apply_call, bwd_call, stats_ext_call,
                   apply_ext_call, bwd_ext_call)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


class FlashApply(torch.autograd.Function):
    """y = v @ (S * alpha(a1x, a2x)) on the band, differentiable in a1x,
    a2x and v (S and the support are structure). Forward: stats_call then
    apply_call, keeping a1x, a2x, v, rowmax and rowsum for backward (alpha
    is recomputed there, never kept). Backward: one bwd_call and the fold
    of its da1 partials, rounded with da2 to the operands' dtype after the
    fold (f32, or bf16 under bf16 training). The JAX package's
    ``flash_apply`` custom VJP.
    """

    @staticmethod
    def forward(ctx, a1x, a2x, v, aux: BandAux, w: int, ibs: int,
                with_s: bool, slope: float):
        rowmax, rowsum = stats_call(a1x, a2x, aux.mask_row, w=w, ibs=ibs,
                                    slope=slope)
        y = apply_call(a1x, a2x, v, rowmax, rowsum, aux.slab_col,
                       aux.mask_col, w=w, ibs=ibs, with_s=with_s, slope=slope,
                       lists=aux.lists)
        ctx.save_for_backward(a1x, a2x, v, rowmax, rowsum)
        ctx.aux, ctx.cfg = aux, (w, ibs, with_s, slope)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        a1x, a2x, v, rowmax, rowsum = ctx.saved_tensors
        w, ibs, with_s, slope = ctx.cfg
        da2, da1p, dv = bwd_call(a1x, a2x, v, rowmax, rowsum,
                                 ctx.aux.slab_col, ctx.aux.mask_row,
                                 g.contiguous(), w=w, ibs=ibs, with_s=with_s,
                                 slope=slope)
        need = ctx.needs_input_grad
        return (fold_window_partials(da1p, w).to(a1x.dtype)
                if need[0] else None,
                da2.to(a2x.dtype) if need[1] else None,
                dv if need[2] else None, None, None, None, None, None)


def flash_apply(a1x: torch.Tensor, a2x: torch.Tensor, v: torch.Tensor,
                aux: BandAux, w: int, ibs: int, with_s: bool = True,
                slope: float = 0.2) -> torch.Tensor:
    """y = v @ (S * alpha(a1x, a2x)) on the band, alpha never materialized.

    a1x, a2x: (Q, Np) score projections (Np = nb*ibs, zero-padded);
    v: (Q, F, Np) signals; aux: the band structure; with_s=False shifts
    with alpha alone (the GCAT convention, reference graphML.py:876-879).
    Returns (Q, F, Np), differentiable in a1x, a2x and v through
    :class:`FlashApply` (CPU tensors: the kernels' plain versions).
    """
    return FlashApply.apply(a1x, a2x, v, aux, w, ibs, with_s, slope)


# ---------------------------------------------------------------------------
# GAT-family entry points (flash counterparts of ops.attention_band)
# ---------------------------------------------------------------------------

def _pad_nodes(t: torch.Tensor, Np: int) -> torch.Tensor:
    """Zero-pad the last (node) axis up to Np; contiguous."""
    n = t.shape[-1]
    if n < Np:
        t = nn.functional.pad(t, (0, Np - n))
    return t.contiguous()


def _projections(x, a, W_p):
    """Wx (B,P,E,F,N), a1Wx/a2Wx (B,P,E,N) from x (B,G,N)."""
    F = W_p.shape[2]
    Wx = torch.einsum("pefg,bgn->bpefn", W_p, x)
    a1, a2 = a[..., :F], a[..., F:]
    a1Wx = torch.einsum("pef,bpefn->bpen", a1, Wx)
    a2Wx = torch.einsum("pef,bpefn->bpen", a2, Wx)
    return Wx, a1Wx, a2Wx


def _scores_per_edge(a1Wx, a2Wx, Np):
    """(B,P,E,N) score projections -> two (E, B*P, Np), padded, contiguous."""
    B, P, E, N = a1Wx.shape

    def per_edge(t):
        return _pad_nodes(t.permute(2, 0, 1, 3).reshape(E, B * P, N), Np)
    return per_edge(a1Wx), per_edge(a2Wx)


def _geometry(slab5_: torch.Tensor):
    """(ibs, Np = nb * ibs) of a (E, nb, W, ibs, ibs) slab."""
    nb, ibs = slab5_.shape[1], slab5_.shape[3]
    return ibs, nb * ibs


def graph_attention_band_flash(x, a, W_p, slab5_, w,
                               n_out: Optional[int] = None,
                               negative_slope: float = 0.2, *,
                               auxes: list):
    """Flash GAT layer: y = sum_e Wx (S_e * alpha_e). Matches
    attention_band.graph_attention_band. Returns (B, P, F, N)."""
    B, G, N = x.shape
    P, E, F, _ = W_p.shape
    ibs, Np = _geometry(slab5_)
    Wx, a1Wx, a2Wx = _projections(x, a, W_p)
    a1p, a2p = _scores_per_edge(a1Wx, a2Wx, Np)
    vp = _pad_nodes(Wx.permute(2, 0, 1, 3, 4).reshape(E, B * P, F, N), Np)
    y = None
    for e in range(E):
        ye = flash_apply(a1p[e], a2p[e], vp[e], auxes[e], w, ibs, True,
                         negative_slope)
        y = ye if y is None else y + ye
    n = N if n_out is None else n_out
    return y.reshape(B, P, F, Np)[..., :n]


def gat_lsigf_band_flash(h, x, a, W_p, slab5_, w, b=None,
                         negative_slope: float = 0.2, *,
                         auxes: list):
    """Flash GCAT: K-tap LSIGF over alpha (shift = alpha alone).
    Matches attention_band.gat_lsigf_band. h: (E,K) -> (B,P,F,N)."""
    E, K = h.shape
    P, _, F, G = W_p.shape
    B, _, N = x.shape
    ibs, Np = _geometry(slab5_)
    _, a1Wx, a2Wx = _projections(x, a, W_p)
    a1p, a2p = _scores_per_edge(a1Wx, a2Wx, Np)
    W_taps = W_p.permute(0, 3, 1, 2).reshape(P, F, E, 1, G)
    hW = h[None, None, :, :, None] * W_taps              # P,F,E,K,G
    x0 = _pad_nodes(x, Np)[:, None].expand(B, P, G, Np).reshape(B * P, G, Np)
    zs = []                                              # per e: K x (BP,G,Np)
    for e in range(E):
        ze = [x0]
        for _ in range(1, K):
            ze.append(flash_apply(a1p[e], a2p[e], ze[-1], auxes[e], w, ibs,
                                  False, negative_slope))
        zs.append(torch.stack(ze))
    z = torch.stack(zs)                                  # E,K,BP,G,Np
    z = z.reshape(E, K, B, P, G, Np)[..., :N]
    y = torch.einsum("ekbpgn,pfekg->bpfn", z, hW)
    return y if b is None else y + b


def gat_evgf_band_flash(x, a, W_p, slab5_, w, b=None,
                        negative_slope: float = 0.2, *,
                        auxes: list):
    """Flash banded attention EVGF (per-hop attention, cumulative product).
    Matches attention_band.gat_evgf_band. a: (P,K,E,2F), W_p: (P,K,E,F,G)
    -> (B,P,F,N)."""
    P, K, E, F, G = W_p.shape
    B, _, N = x.shape
    ibs, Np = _geometry(slab5_)

    def apply_all(k, v):
        """Hop k's attention shift of v (E, BP, F, Np)."""
        _, a1Wx, a2Wx = _projections(x, a[:, k], W_p[:, k])
        a1p, a2p = _scores_per_edge(a1Wx, a2Wx, Np)
        return torch.stack([
            flash_apply(a1p[e], a2p[e], v[e], auxes[e], w, ibs, True,
                        negative_slope)
            for e in range(E)])

    v = torch.einsum("pefg,bgn->ebpfn", W_p[:, 0], x).reshape(E, B * P, F, N)
    v = apply_all(0, _pad_nodes(v, Np))
    y = v
    for k in range(1, K):
        v = apply_all(k, v)
        y = y + v
    y = y.sum(0).reshape(B, P, F, Np)[..., :N]
    return y if b is None else y + b
