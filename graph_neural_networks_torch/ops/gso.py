"""The Graph Shift Operator container and the shift primitive.

A :class:`Gso` holds the GSO of E edge features on one device in one of
three layouts, chosen by ``mode``:

  * ``dense`` -- (E, N, N); a shift is one ``torch.einsum``.
  * ``band``  -- per-edge-feature band slabs; a shift runs
    :func:`spmm.band_matmul`, and the K-tap register may run the fused
    :func:`spmm.band_shift_register`.
  * ``bcsr``  -- the nonzero 128x128 blocks, sorted by block column; a
    shift runs :func:`spmm.bcsr_matmul`.

The fourth GSO container, the COO ``attention_sparse.EdgeList`` of the S+I
support (``gsoMode='edge'``), shifts by a gather and an ``index_add_``.

The shift convention is the JAX package's: signals are row vectors per
node, so one shift is ``y = x @ S_e``, i.e.
``y[..., m] = sum_n x[..., n] * S[e, n, m]``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from graph_neural_networks_torch.ops import attention_sparse as asp
from graph_neural_networks_torch.ops import spmm
from graph_neural_networks_torch.utils.device import resolve_device

MODES = ("dense", "band", "bcsr")


@dataclasses.dataclass
class Gso:
    """Device-ready graph shift operator.

    S : (E, N, N) dense GSO (None only if dropped by the caller).
    s_band, s_band_t : (E, nb, (2w+1)*bs, bs) band slab of S and of S^T.
    blocks, blocks_t : (E, nnzb, bs, bs) BCSR blocks of S and of S^T, with
        (nnzb,) int32 block_row/block_col (and *_t) shared by all E, and
        each layout's (nb + 1,) int32 segment offsets col_start (and
        col_start_t; ``spmm.bcsr_col_start``), built once with it.
    The transposed layouts serve the backward shift (spmm.BandShift,
    BandRegister, BcsrShift).
    """

    S: Optional[torch.Tensor]
    n: int
    n_edge_features: int = 1
    mode: str = "dense"
    block_size: int = 128
    band_w: int = 0
    s_band: Optional[torch.Tensor] = None
    s_band_t: Optional[torch.Tensor] = None
    blocks: Optional[torch.Tensor] = None
    block_row: Optional[torch.Tensor] = None
    block_col: Optional[torch.Tensor] = None
    blocks_t: Optional[torch.Tensor] = None
    block_row_t: Optional[torch.Tensor] = None
    block_col_t: Optional[torch.Tensor] = None
    col_start: Optional[torch.Tensor] = None
    col_start_t: Optional[torch.Tensor] = None

    @property
    def N(self) -> int:
        return self.n

    @property
    def E(self) -> int:
        return self.n_edge_features

    def to(self, device=None, dtype=None) -> "Gso":
        """A copy with every tensor on `device` and the float ones (S, the
        band slabs, the BCSR blocks) in `dtype` (the int32 structure kept);
        self when nothing changes, so what is cached on it (the attention
        band structure of ``attention_flash.band_auxes``) is kept. A copy
        in another dtype on the same device casts that cache too, and
        rebuilds nothing; a copy on another device drops it (its first
        use builds it there)."""
        dev = None if device is None else torch.device(device)
        tensors = [t for t in (getattr(self, f.name)
                               for f in dataclasses.fields(self))
                   if isinstance(t, torch.Tensor)]
        moves = dev is not None and not all(
            t.device.type == dev.type and dev.index in (None, t.device.index)
            for t in tensors)
        casts = dtype is not None and any(
            t.is_floating_point() and t.dtype != dtype for t in tensors)
        if not (moves or casts):
            return self

        def conv(t):
            if moves:
                t = t.to(dev)
            if casts and t.is_floating_point():
                t = t.to(dtype)
            return t

        out = dataclasses.replace(self, **{
            f.name: conv(getattr(self, f.name))
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})
        auxes = getattr(self, "_band_auxes", None)
        if auxes is not None and not moves:
            out._band_auxes = [type(aux)(*map(conv, aux)) for aux in auxes]
        return out


def cast_ctx(v, dtype: torch.dtype):
    """An architecture's context entry with its float tensors in `dtype`
    (a Gso by :meth:`Gso.to`, which casts its cached band structure and
    rebuilds nothing; tuples and lists entry by entry), its integer tables
    kept: the JAX package's cast of ctx's float leaves
    (``_ctx_for_dtype``), shared by bf16 serving and bf16 training. A
    ``parallel.ShardedGso`` gives its twin in `dtype` (:meth:`ShardedGso.to`:
    its per-shard slabs, blocks and masks cast once, integer tables and
    entry lists shared). An ``attention_sparse.EdgeList`` gives a copy
    with its s_val cast (:meth:`EdgeList.to`; row and col shared). Any
    other object raises."""
    from graph_neural_networks_torch.parallel.sharded_gso import ShardedGso
    if isinstance(v, torch.Tensor):
        return v.to(dtype) if v.is_floating_point() else v
    if isinstance(v, (Gso, ShardedGso, asp.EdgeList)):
        return v.to(dtype=dtype)
    if isinstance(v, (tuple, list)):
        return type(v)(cast_ctx(t, dtype) for t in v)
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    raise TypeError(f"cast_ctx: a context entry of type "
                    f"{type(v).__name__} has no {dtype} cast")


def _normalize_dense(S) -> np.ndarray:
    S = np.asarray(S, dtype=np.float64)
    if S.ndim == 2:
        S = S[None]
    if not (S.ndim == 3 and S.shape[1] == S.shape[2]):
        raise ValueError(f"GSO must be (N, N) or (E, N, N), got {S.shape}")
    return S


def _band_layouts(S: np.ndarray, block_size: int):
    """Band slabs of every S[e] and S[e]^T at one common w."""
    E = S.shape[0]
    w_max = max(spmm.dense_to_band(S[e], block_size)[1] for e in range(E))
    slabs, slabs_t = [], []
    for e in range(E):
        sb, _ = spmm.dense_to_band(S[e], block_size)
        sbt, _ = spmm.dense_to_band(S[e].T, block_size)
        # re-extract at the common w so all edge features share a slab shape
        if sb.shape[1] != (2 * w_max + 1) * block_size:
            sb = spmm.dense_to_band_at(S[e], block_size, w_max)
            sbt = spmm.dense_to_band_at(S[e].T, block_size, w_max)
        slabs.append(sb)
        slabs_t.append(sbt)
    return np.stack(slabs), np.stack(slabs_t), w_max


def _bcsr_layouts(S: np.ndarray, block_size: int):
    """BCSR blocks of every S[e] on one shared pattern, and the transposed
    layout; each with its segment offsets (``spmm.bcsr_col_start``)."""
    E = S.shape[0]
    blocks, brow, bcol = [], None, None
    for e in range(E):
        b, r, c = spmm.dense_to_bcsr(S[e], block_size)
        blocks.append(b)
        if brow is None:
            brow, bcol = r, c
        elif not (np.array_equal(r, brow) and np.array_equal(c, bcol)):
            # edge features with different patterns share the union pattern
            _, brow, bcol = spmm.dense_to_bcsr(np.abs(S).sum(0), block_size)
            blocks = [spmm.dense_to_bcsr_with_pattern(S[ee], block_size,
                                                      brow, bcol)
                      for ee in range(E)]
            break
    blocks = np.stack(blocks)
    tr = [spmm.bcsr_transpose(blocks[e], brow, bcol) for e in range(E)]
    N = S.shape[1]
    return (blocks, brow, bcol, spmm.bcsr_col_start(bcol, N, block_size),
            np.stack([t[0] for t in tr]), tr[0][1], tr[0][2],
            spmm.bcsr_col_start(tr[0][2], N, block_size))


def as_gso(S, mode: str = "dense", block_size: int = 128,
           device="cuda") -> Gso:
    """Build a :class:`Gso` on `device` from a dense (N, N) or (E, N, N)
    array. A Gso passes through (moved to `device`)."""
    dev = resolve_device(device)
    if isinstance(S, Gso):
        return S.to(dev)
    if mode not in MODES:
        raise ValueError(f"unknown GSO mode {mode!r}; one of {MODES}")
    S = _normalize_dense(S)
    E, N, _ = S.shape

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)

    gso = Gso(S=f32(S), n=N, n_edge_features=E, mode=mode,
              block_size=block_size)
    if mode == "band":
        s_band, s_band_t, w = _band_layouts(S, block_size)
        gso.s_band, gso.s_band_t, gso.band_w = f32(s_band), f32(s_band_t), w
    elif mode == "bcsr":
        (blocks, brow, bcol, cs, blocks_t, brow_t, bcol_t,
         cs_t) = _bcsr_layouts(S, block_size)
        gso.blocks, gso.block_row, gso.block_col, gso.col_start = \
            f32(blocks), i32(brow), i32(bcol), i32(cs)
        gso.blocks_t, gso.block_row_t, gso.block_col_t, gso.col_start_t = \
            f32(blocks_t), i32(brow_t), i32(bcol_t), i32(cs_t)
    return gso


def dense(gso) -> torch.Tensor:
    """The (E, N, N) dense GSO of a Gso or a raw (N, N)/(E, N, N) tensor."""
    if isinstance(gso, Gso):
        if gso.S is None:
            raise ValueError("this Gso holds no dense GSO")
        return gso.S
    S = torch.as_tensor(gso)
    return S[None] if S.ndim == 2 else S


def gshift(gso, x: torch.Tensor) -> torch.Tensor:
    """One graph shift: ``y[..., e, g, m] = sum_n x[..., e, g, n] S[e,n,m]``.

    x: (..., E, G, N) with E matching the GSO's edge features. Dense mode
    (or a raw tensor) is one einsum; band and bcsr flatten every axis but
    (E, N) into rows and run one kernel launch per edge feature. An
    ``attention_sparse.EdgeList`` shifts over its edges (a gather and an
    ``index_add_``, no kernel). Any other object with a ``shift(x)``
    method (``parallel.ShardedGso``, the node-sharded ring shift) shifts x
    itself.
    """
    if isinstance(gso, asp.EdgeList):
        # y[..., e, g, m] = sum over the edges (n -> m) of
        # x[..., e, g, n] * s_val[e, edge]
        return asp.edge_shift(x, gso.s_val, gso)
    if not isinstance(gso, (Gso, torch.Tensor, np.ndarray)) \
            and hasattr(gso, "shift"):
        return gso.shift(x)
    if not isinstance(gso, Gso) or gso.mode == "dense":
        return torch.einsum("...egn,enm->...egm", x, dense(gso))
    E = gso.n_edge_features
    shp = x.shape
    N = shp[-1]
    xg = torch.movedim(x, -3, 0).reshape(E, -1, N).contiguous()  # (E, R, N)
    if gso.mode == "band":
        outs = [spmm.BandShift.apply(xg[e], gso.s_band[e], gso.s_band_t[e],
                                     N, gso.band_w, gso.block_size)
                for e in range(E)]
    else:
        outs = [spmm.BcsrShift.apply(xg[e], gso.blocks[e], gso.block_row,
                                     gso.block_col, gso.blocks_t[e],
                                     gso.block_row_t, gso.block_col_t, N,
                                     gso.block_size, gso.col_start,
                                     gso.col_start_t)
                for e in range(E)]
    y = torch.stack(outs).reshape((E,) + shp[:-3] + shp[-2:-1] + (N,))
    return torch.movedim(y, 0, -3)


def gshift_register(gso, x: torch.Tensor, K: int) -> torch.Tensor:
    """The K-tap shift register [x, xS, ..., xS^{K-1}] stacked on a new
    axis: (B, E, G, N) -> (B, E, K, G, N).

    On the band layout with f32 or bf16 signals (the slab in the same
    dtype) and at most ``spmm.REGISTER_MAX_ROWS`` rows (B*G) it runs the
    fused :func:`spmm.band_shift_register`, one launch per edge feature for
    all K taps, when the kernel takes the block size and bandwidth
    (``spmm.register_fits``). (The JAX package chains bf16 signals, a speed
    rule of its TPU; both compute each tap rounded to bf16.)
    Everywhere else (an EdgeList too, as in the JAX package) it chains
    K-1 :func:`gshift` calls.
    """
    if K == 1:
        return x[:, :, None]
    rows = x.shape[0] * x.shape[2] if x.ndim == 4 else 0
    fused = (
        isinstance(gso, Gso) and gso.mode == "band"
        and x.dtype in (torch.float32, torch.bfloat16) and x.ndim == 4
        and gso.s_band.dtype == x.dtype
        and rows <= spmm.REGISTER_MAX_ROWS
        and spmm.register_fits(gso.block_size, gso.band_w)
    )
    if fused:
        E = gso.n_edge_features
        B, E_, G, N = x.shape
        if E_ != E:
            raise ValueError(f"x has {E_} edge features, the GSO {E}")
        xg = torch.movedim(x, 1, 0).reshape(E, B * G, N).contiguous()
        outs = [spmm.BandRegister.apply(xg[e], gso.s_band[e],
                                        gso.s_band_t[e], K, N, gso.band_w,
                                        gso.block_size)
                for e in range(E)]
        z = torch.stack(outs).reshape(E, K, B, G, N)
        return z.permute(2, 0, 1, 3, 4)
    zs = [x]
    for _ in range(1, K):
        x = gshift(gso, x)
        zs.append(x)
    return torch.stack(zs, dim=2)
