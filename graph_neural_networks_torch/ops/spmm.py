"""The graph shift ``y = x @ S`` on block-sparse layouts: host layouts,
three CUDA kernels, and their plain PyTorch versions.

Layouts (built once on the host by the native library,
``utils/native.py``, or by their numpy plain versions under
``GNT_NO_NATIVE``; bit-identical to the JAX package's ``ops/spmm.py``):

  * band  -- S block-banded with block bandwidth w, stored as the slab
    ``s_band (nb, (2w+1)*bs, bs)``: ``s_band[j, t*bs:(t+1)*bs]`` is the S
    block at (block row j+t-w, block column j), zero where that falls off
    the matrix.
  * bcsr  -- the nonzero (bs, bs) blocks of S with their block row and
    column ids, sorted by (column, row).

Kernels (``kernels/csrc/spmm.cu``), each behind a wrapper of the same name:

  * :func:`band_matmul` -- y = x @ S on the band slab.
  * :func:`band_shift_register` -- [x, xS, ..., xS^{K-1}] in one launch.
  * :func:`bcsr_matmul` -- y = x @ S on the BCSR blocks.

Each kernel has an f32 and a bf16 io instance: x and S in one of the two
dtypes, y in the same, the products accumulated in f32 (the JAX kernels'
f32 accumulator). The f32 instances run true-f32 FMAs (the JAX default
precision): the large f32 shifts are bound by FP32 operations. The bf16
instances keep bf16 in shared memory, staged by 16-byte ``cp.async``, and
run the products on tensor cores (``mma.sync`` m16n8k16, bf16 in, f32
accumulators): a bf16 product is exact in f32, so they compute the same
function, their f32 sums in another order; on tensor cores the bf16 shifts
are bound by bytes. The plain versions take bf16 too: they compute in f32
and round y (each tap of the register) to bf16, where the JAX kernels
round.

Each wrapper calls a ``torch.library`` op of the ``gnt`` namespace
(``torch.ops.gnt.band_matmul``, ``band_shift_register``, ``bcsr_matmul``)
with a CPU implementation (the plain version), a CUDA one (the kernel
launch) and a fake one (the output's shape, for ``torch.export`` and
``FlopCounterMode``), and a flop formula (``register_flop_formula``). So a
wrapper runs its ``*_plain`` version when x lies on the CPU, and launches
its kernel when x lies on a CUDA device; it never falls back from one to
the other. Each kernel launch adds one to the wrapper's ``launches``
count, and each call of an op one to ``kernels.OP_CALLS[name, dtype]``.
On the CPU a call that needs a gradient runs the plain version directly
(the op records none).

Gradients go through three ``torch.autograd.Function``s, the JAX package's
custom VJPs (S is structure, not differentiated): :class:`BandShift`
and :class:`BcsrShift` (also on a rectangular S, one shard's column
slice) shift the cotangent by S^T on the transposed layout
(``s_band_t``, ``blocks_t``), and :class:`BandRegister` runs the Horner
chain dx = g_0 + (g_1 + (...) S^T) S^T of K-1 ``band_matmul``s. All
backward work runs on the same three kernels. The raw wrappers record no
gradient: on CUDA, with grad enabled and an input that requires grad, they
raise NotImplementedError naming the Function to call.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from graph_neural_networks_torch import kernels
from graph_neural_networks_torch.utils import native

ZERO_TOL = 1e-9

# Output column tile of the CUDA kernels (kBN in kernels/csrc/spmm.cu): a
# tile never straddles two S block columns, so block_size must be a
# multiple of it on CUDA.
TILE_N = 64

# Row-count rule for the fused register (gso.gshift_register): fused for at
# most this many rows, chained band_matmul above. Both compute the same
# function: a speed rule only. chip_smoke.py's register_sweep measures it on
# an H100 (N = 4096, w = 1, K = 5; see PERF.md): the register beat K-1
# chained band_matmul at every swept row count up to 2048 while band_matmul
# ran a 64 x 64 tile loop of its own; since band_matmul runs the BCSR
# mainloop, the chain is as fast at 256 rows and faster above. The rule
# still fuses up to 2048 rows, which keeps the launch counts of the band
# paths; moving it is a change of its own, measured end to end.
REGISTER_MAX_ROWS = 2048

# band_shift_register's CUDA blocks: a 32-column output panel of the slab
# kept in shared memory, and two staged slices of the previous tap, at most
# 128 rows x (32 + 4) floats (kPanel, kWideTM, kWideKD in
# kernels/csrc/spmm.cu); the shared memory one block may use on the H100
# (227 KB). The bf16 kernel's fallback tile (RegWide32): a 32-column panel
# in bf16 whose rows are padded by 8 to 40 elements, and two staged slices
# of 128 rows x (64 + 8) bf16.
REGISTER_PANEL = 32
REGISTER_SLICE_FLOATS = 128 * (32 + 4)
REGISTER_BF16_PANEL_ROW = 32 + 8
REGISTER_BF16_SLICE = 128 * (64 + 8)
SMEM_PER_BLOCK = 232448


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# Host layouts (numpy)
# ---------------------------------------------------------------------------

def _tiles(S: np.ndarray, block_size: int, dtype) -> np.ndarray:
    """S zero-padded to whole blocks, as (nb, nb, bs, bs) tiles."""
    N = S.shape[0]
    nb = _cdiv(N, block_size)
    Sp = np.zeros((nb * block_size, nb * block_size), dtype=dtype)
    Sp[:N, :N] = S
    return Sp.reshape(nb, block_size, nb, block_size).transpose(0, 2, 1, 3)


def dense_to_bcsr(S: np.ndarray, block_size: int = 128):
    """Tile a dense N x N matrix into its nonzero (bs x bs) blocks.

    Returns (blocks (nnzb, bs, bs) f32, block_row (nnzb,) i32, block_col
    (nnzb,) i32), sorted by (block_col, block_row). N is zero-padded up to
    a multiple of block_size; an all-zero S keeps one zero block. Runs the
    native library (``utils.native.bcsr_extract``, as the JAX package
    does) unless ``GNT_NO_NATIVE`` is set, which takes this numpy version.
    """
    N = S.shape[0]
    if S.shape != (N, N):
        raise ValueError(f"S must be square, got {S.shape}")
    if native.enabled():
        return native.bcsr_extract(np.asarray(S, np.float32), block_size)
    tiles = _tiles(S, block_size, S.dtype)
    nz = np.abs(tiles).sum(axis=(2, 3)) > ZERO_TOL
    rows, cols = np.nonzero(nz)
    order = np.lexsort((rows, cols))  # sort by col, then row
    rows, cols = rows[order], cols[order]
    if len(rows) == 0:  # keep at least one (zero) block for static shapes
        rows = np.array([0])
        cols = np.array([0])
    blocks = tiles[rows, cols]
    return blocks.astype(np.float32), rows.astype(np.int32), cols.astype(np.int32)


def dense_to_bcsr_with_pattern(S: np.ndarray, block_size: int,
                               block_row: np.ndarray, block_col: np.ndarray):
    """The blocks of S at a fixed (block_row, block_col) pattern."""
    tiles = _tiles(S, block_size, S.dtype)
    return tiles[block_row, block_col].astype(np.float32)


def bcsr_transpose(blocks: np.ndarray, rows: np.ndarray, cols: np.ndarray):
    """Transpose a BCSR layout: swap row/col ids, transpose each tile,
    re-sort by (col, row)."""
    t_rows = np.asarray(cols)
    t_cols = np.asarray(rows)
    t_blocks = np.ascontiguousarray(np.swapaxes(np.asarray(blocks), 1, 2))
    order = np.lexsort((t_rows, t_cols))
    return (t_blocks[order], t_rows[order].astype(np.int32),
            t_cols[order].astype(np.int32))


def _band_slab(tiles: np.ndarray, w: int) -> np.ndarray:
    nb, _, bs, _ = tiles.shape
    s_band = np.zeros((nb, (2 * w + 1) * bs, bs), dtype=np.float32)
    for j in range(nb):
        for k, i in enumerate(range(j - w, j + w + 1)):
            if 0 <= i < nb:
                s_band[j, k * bs:(k + 1) * bs] = tiles[i, j]
    return s_band


def dense_to_band(S: np.ndarray, block_size: int = 128):
    """Extract the block band of S: returns (s_band (nb, (2w+1)*bs, bs), w)
    with w the smallest block bandwidth that covers every nonzero (w = nb-1
    degenerates to dense). Natively (a pass at w = 0 finds w, a second
    extracts) unless ``GNT_NO_NATIVE`` is set, as :func:`dense_to_bcsr`."""
    if native.enabled():
        S32 = np.asarray(S, np.float32)
        _, w = native.band_extract(S32, block_size, 0)
        return native.band_extract(S32, block_size, w)[0], w
    tiles = _tiles(S, block_size, np.float32)
    nz = np.abs(tiles).sum(axis=(2, 3)) > ZERO_TOL
    rows, cols = np.nonzero(nz)
    w = int(np.abs(rows - cols).max()) if len(rows) else 0
    return _band_slab(tiles, w), w


def dense_to_band_at(S: np.ndarray, block_size: int, w: int) -> np.ndarray:
    """The band slab at a fixed block bandwidth w (nonzeros outside are
    dropped; callers pick w >= the true bandwidth); natively unless
    ``GNT_NO_NATIVE`` is set."""
    if native.enabled():
        return native.band_extract(np.asarray(S, np.float32), block_size,
                                   w)[0]
    return _band_slab(_tiles(S, block_size, np.float32), w)


def auto_col_tile(n_cols: int, block_size: int = 128) -> int:
    """Largest col_tile in {4, 2, 1} dividing the block count: the JAX
    band kernel's column tiling for this layout."""
    nb = _cdiv(n_cols, block_size)
    for c in (4, 2):
        if nb % c == 0:
            return c
    return 1


def auto_row_tile(n_rows: int) -> int:
    """The JAX BCSR kernel's row tile for this row count: the largest of
    1024, 512, 256 not above it (256 below that)."""
    for rt in (1024, 512, 256):
        if n_rows >= rt:
            return rt
    return 256


def register_smem_bytes(block_size: int, w: int,
                        dtype: torch.dtype = torch.float32) -> int:
    """Shared memory of one band_shift_register block on CUDA at the tile
    that must fit. f32: the larger tile, the (2w+1)*bs x 32 slab panel it
    keeps for all taps and two staged (128, 32 + 4) slices
    (``register_smem_bytes`` in spmm.cu). bf16: the fallback tile,
    (2w+1)*bs panel rows of 32 + 8 bf16 and two staged (128, 64 + 8) bf16
    slices (``RegWide32::smem``); the kernel takes a wider panel where one
    fits."""
    rows = (2 * w + 1) * block_size
    if dtype == torch.bfloat16:
        return 2 * (rows * REGISTER_BF16_PANEL_ROW + 2 * REGISTER_BF16_SLICE)
    return 4 * (rows * REGISTER_PANEL + 2 * REGISTER_SLICE_FLOATS)


def register_fits(block_size: int, w: int,
                  dtype: torch.dtype = torch.float32) -> bool:
    """Whether band_shift_register's CUDA kernel for ``dtype`` takes this
    layout.

    The JAX kernel keeps a whole row stripe resident in VMEM, so it tests
    the stripe's size. The CUDA kernel keeps a panel of the slab resident
    in a block's shared memory for all K-1 taps, so it tests that panel
    (with the staged slices) against the 227 KB a block may use: in f32 at
    block_size 128 it takes w <= 5, at 64 w <= 11, whatever the row count.
    The bf16 kernel's fallback panel is smaller, so it takes a superset
    (w <= 9 at 128, w <= 18 at 64). Its column tiles must also not straddle
    a band block (block_size % TILE_N == 0). ``gso.gshift_register`` fuses
    by the f32 rule in either dtype, so a bf16 model fuses where the f32
    one does.
    """
    return (block_size % TILE_N == 0
            and register_smem_bytes(block_size, w, dtype) <= SMEM_PER_BLOCK)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path, and the reference on the card)
# ---------------------------------------------------------------------------

def _f32(t: torch.Tensor) -> torch.Tensor:
    """A bf16 operand upcast to f32 (the plain versions compute in f32);
    f32 (and f64) as it is."""
    return t.float() if t.dtype == torch.bfloat16 else t


def band_matmul_plain(x: torch.Tensor, s_band: torch.Tensor, *, n_cols: int,
                      w: int, block_size: int = 128) -> torch.Tensor:
    """y = x @ S for S in the band layout: x (R, N) -> y (R, n_cols).
    bf16 x and s_band: computed in f32, y rounded to bf16 once."""
    if x.dtype == torch.bfloat16:
        return band_matmul_plain(_f32(x), _f32(s_band), n_cols=n_cols, w=w,
                                 block_size=block_size).to(x.dtype)
    R, N = x.shape
    bs = block_size
    nb = _cdiv(n_cols, bs)
    xb = x.new_zeros((R, nb * bs))
    xb[:, :N] = x
    xb = xb.view(R, nb, bs)
    y = x.new_zeros((R, nb, bs))
    for t in range(2 * w + 1):
        # output block columns j whose window block i = j + t - w exists
        j0, j1 = max(0, w - t), min(nb, nb + w - t)
        if j0 >= j1:
            continue
        i0, i1 = j0 + t - w, j1 + t - w
        y[:, j0:j1] += torch.einsum(
            "rjb,jbc->rjc", xb[:, i0:i1], s_band[j0:j1, t * bs:(t + 1) * bs])
    return y.reshape(R, nb * bs)[:, :n_cols]


def band_shift_register_plain(x: torch.Tensor, s_band: torch.Tensor, *,
                              n_taps: int, n_cols: int, w: int,
                              block_size: int = 128) -> torch.Tensor:
    """(R, N) -> (K, R, N) = [x, xS, ..., xS^{K-1}] for S in the band
    layout; in bf16 each tap is rounded before the next reads it (the JAX
    kernel's io-dtype buffer)."""
    zs = [x]
    for _ in range(1, n_taps):
        zs.append(band_matmul_plain(zs[-1], s_band, n_cols=n_cols, w=w,
                                    block_size=block_size))
    return torch.stack(zs)


def bcsr_matmul_plain(x: torch.Tensor, blocks: torch.Tensor,
                      block_row: torch.Tensor, block_col: torch.Tensor, *,
                      n_cols: int, block_size: int = 128) -> torch.Tensor:
    """y = x @ S for S in the BCSR layout: gather x's block columns by
    block_row, one product per block, add into output block columns by
    block_col. x (R, N) sits on its own block grid; y is (R, n_cols).
    bf16 x and blocks: computed in f32, y rounded to bf16 once."""
    if x.dtype == torch.bfloat16:
        return bcsr_matmul_plain(_f32(x), _f32(blocks), block_row, block_col,
                                 n_cols=n_cols,
                                 block_size=block_size).to(x.dtype)
    R, N = x.shape
    bs = block_size
    nb_in, nb_out = _cdiv(N, bs), _cdiv(n_cols, bs)
    xp = x.new_zeros((R, nb_in * bs))
    xp[:, :N] = x
    xg = xp.view(R, nb_in, bs)[:, block_row.long()]          # (R, nnzb, bs)
    contrib = torch.einsum("rkb,kbc->rkc", xg, blocks)
    y = x.new_zeros((R, nb_out, bs)).index_add_(1, block_col.long(), contrib)
    return y.reshape(R, nb_out * bs)[:, :n_cols]


# ---------------------------------------------------------------------------
# The ops (torch.library): CPU = the plain version, CUDA = the kernel
# ---------------------------------------------------------------------------

_LIB = torch.library.Library("gnt", "FRAGMENT")
_LIB.define("band_matmul(Tensor x, Tensor s_band, int n_cols, int w, "
            "int block_size) -> Tensor")
_LIB.define("band_shift_register(Tensor x, Tensor s_band, int n_taps, "
            "int n_cols, int w, int block_size) -> Tensor")
_LIB.define("bcsr_matmul(Tensor x, Tensor blocks, Tensor block_row, "
            "Tensor block_col, Tensor? col_start, int n_cols, "
            "int block_size) -> Tensor")


def _check_kernel_inputs(name: str, block_size: int, x: torch.Tensor,
                         **tensors) -> torch.dtype:
    """The io dtype (x's: f32 or bf16); raises unless every float operand
    has it, the structure is int32, every tensor is contiguous and the
    block size tiles."""
    dt = kernels.io_dtype(name, x)
    kernels.check_inputs(name, x=(x, dt), **{
        arg: (t, dt if t.is_floating_point() else torch.int32)
        for arg, t in tensors.items()})
    if block_size % TILE_N:
        raise ValueError(f"{name}: the CUDA kernel needs block_size a "
                         f"multiple of {TILE_N}, got {block_size}")
    return dt


def _band_matmul_cpu(x, s_band, n_cols, w, block_size):
    kernels.OP_CALLS["band_matmul", x.dtype] += 1
    return band_matmul_plain(x, s_band, n_cols=n_cols, w=w,
                             block_size=block_size)


def _band_matmul_cuda(x, s_band, n_cols, w, block_size):
    dt = _check_kernel_inputs("band_matmul", block_size, x, s_band=s_band)
    R, N = x.shape
    y = torch.empty((R, n_cols), dtype=dt, device=x.device)
    if R == 0:
        return y
    err = kernels.entry("gnt_band_matmul", dt)(
        x.data_ptr(), s_band.data_ptr(), y.data_ptr(), R, N, n_cols,
        _cdiv(n_cols, block_size), w, block_size, kernels.stream())
    kernels.check(err, "band_matmul")
    band_matmul.launches += 1
    kernels.OP_CALLS["band_matmul", dt] += 1
    return y


def _band_shift_register_cpu(x, s_band, n_taps, n_cols, w, block_size):
    kernels.OP_CALLS["band_shift_register", x.dtype] += 1
    return band_shift_register_plain(x, s_band, n_taps=n_taps, n_cols=n_cols,
                                     w=w, block_size=block_size)


def _band_shift_register_cuda(x, s_band, n_taps, n_cols, w, block_size):
    dt = _check_kernel_inputs("band_shift_register", block_size, x,
                              s_band=s_band)
    if not register_fits(block_size, w, dt):
        raise ValueError(f"band_shift_register: the slab panel of w={w}, "
                         f"bs={block_size} does not fit a block's shared "
                         f"memory ({register_smem_bytes(block_size, w, dt)} "
                         f"> {SMEM_PER_BLOCK} bytes); chain band_matmul "
                         "instead")
    R, N = x.shape
    out = torch.empty((n_taps, R, N), dtype=dt, device=x.device)
    if R == 0:
        return out
    err = kernels.entry("gnt_band_register", dt)(
        x.data_ptr(), s_band.data_ptr(), out.data_ptr(), R, N,
        _cdiv(n_cols, block_size), w, block_size, n_taps, kernels.stream())
    kernels.check(err, "band_shift_register")
    band_shift_register.launches += 1
    kernels.OP_CALLS["band_shift_register", dt] += 1
    return out


def _bcsr_matmul_cpu(x, blocks, block_row, block_col, col_start, n_cols,
                     block_size):
    kernels.OP_CALLS["bcsr_matmul", x.dtype] += 1
    return bcsr_matmul_plain(x, blocks, block_row, block_col, n_cols=n_cols,
                             block_size=block_size)


def _bcsr_matmul_cuda(x, blocks, block_row, block_col, col_start, n_cols,
                      block_size):
    dt = _check_kernel_inputs("bcsr_matmul", block_size, x, blocks=blocks,
                              block_row=block_row, block_col=block_col)
    if col_start is None:
        col_start = bcsr_col_start(block_col, n_cols, block_size)
    kernels.check_inputs("bcsr_matmul", col_start=(col_start, torch.int32))
    R, N = x.shape
    y = torch.empty((R, n_cols), dtype=dt, device=x.device)
    if R == 0:
        return y
    err = kernels.entry("gnt_bcsr_matmul", dt)(
        x.data_ptr(), blocks.data_ptr(), block_row.data_ptr(),
        col_start.data_ptr(), y.data_ptr(), R, N, n_cols, block_size,
        kernels.stream())
    kernels.check(err, "bcsr_matmul")
    bcsr_matmul.launches += 1
    kernels.OP_CALLS["bcsr_matmul", dt] += 1
    return y


for _name, _cpu, _cuda in (
        ("band_matmul", _band_matmul_cpu, _band_matmul_cuda),
        ("band_shift_register", _band_shift_register_cpu,
         _band_shift_register_cuda),
        ("bcsr_matmul", _bcsr_matmul_cpu, _bcsr_matmul_cuda)):
    _LIB.impl(_name, _cpu, "CPU")
    _LIB.impl(_name, _cuda, "CUDA")


@torch.library.register_fake("gnt::band_matmul", lib=_LIB)
def _(x, s_band, n_cols, w, block_size):
    return x.new_empty((x.shape[0], n_cols))


@torch.library.register_fake("gnt::band_shift_register", lib=_LIB)
def _(x, s_band, n_taps, n_cols, w, block_size):
    return x.new_empty((n_taps,) + tuple(x.shape))


@torch.library.register_fake("gnt::bcsr_matmul", lib=_LIB)
def _(x, blocks, block_row, block_col, col_start, n_cols, block_size):
    return x.new_empty((x.shape[0], n_cols))


# Flop counts: the JAX kernels' pl.CostEstimate (ops/spmm.py:203-206 for
# bcsr_matmul, :668-671 for band_matmul) on the rows the port computes (it
# pads none): 2 flops for each entry of each stored block a row meets (the
# band slab's off-matrix blocks included, as there); the register K-1
# band_matmuls.
@register_flop_formula(torch.ops.gnt.band_matmul)
def _(x_shape, s_band_shape, *args, out_shape=None, **kwargs) -> int:
    return 2 * x_shape[0] * math.prod(s_band_shape)


@register_flop_formula(torch.ops.gnt.band_shift_register)
def _(x_shape, s_band_shape, n_taps, *args, out_shape=None, **kwargs) -> int:
    return (n_taps - 1) * 2 * x_shape[0] * math.prod(s_band_shape)


@register_flop_formula(torch.ops.gnt.bcsr_matmul)
def _(x_shape, blocks_shape, *args, out_shape=None, **kwargs) -> int:
    return 2 * x_shape[0] * math.prod(blocks_shape)


_BAND_MATMUL = torch.ops.gnt.band_matmul.default
_BAND_SHIFT_REGISTER = torch.ops.gnt.band_shift_register.default
_BCSR_MATMUL = torch.ops.gnt.bcsr_matmul.default



# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def band_matmul(x: torch.Tensor, s_band: torch.Tensor, *, n_cols: int,
                w: int, block_size: int = 128) -> torch.Tensor:
    """y = x @ S for block-banded S: x (R, N), s_band (nb, (2w+1)*bs, bs)
    with nb = ceil(n_cols / bs) -> y (R, n_cols), in x's dtype (f32 or
    bf16; s_band in the same). x's columns past N count as zero (N <=
    nb*bs).

    CUDA kernel: the BCSR mainloop on the band slab's blocks, replacing
    the Pallas kernel of the JAX package's ``ops/spmm.py:band_matmul``. In
    f32 ``bcsr_matmul_kernel<BandBlocks>`` (above 64 rows) or
    ``bcsr_narrow_kernel<BM, BandBlocks>`` in kernels/csrc/spmm.cu: FP32
    FMAs, bound by FP32 operations at many rows. In bf16
    ``bcsr_mma_kernel<., BandBlocks, bf16>``: bf16 tiles staged by
    ``cp.async`` into a ring of stages, products on tensor cores
    (``mma.sync``, f32 accumulators), 128 x 128 output tiles above 64 rows
    (one x window read from L2 per block column of S; 128 x 64 where those
    would leave SMs idle), BM x 16 at most 64 rows; bound by bytes.
    """
    R, N = x.shape
    bs = block_size
    nb = _cdiv(n_cols, bs)
    if tuple(s_band.shape) != (nb, (2 * w + 1) * bs, bs):
        raise ValueError(f"band_matmul: s_band {tuple(s_band.shape)} does "
                         f"not fit n_cols={n_cols}, w={w}, bs={bs}")
    if N > nb * bs:
        raise ValueError(f"band_matmul: x has {N} columns, S only {nb * bs}")
    if not kernels.on_cuda("band_matmul", x, s_band) and kernels.needs_grad(
            x, s_band):
        return band_matmul_plain(x, s_band, n_cols=n_cols, w=w, block_size=bs)
    return _BAND_MATMUL(x, s_band, n_cols, w, bs)


band_matmul.launches = 0


def band_shift_register(x: torch.Tensor, s_band: torch.Tensor, *,
                        n_taps: int, n_cols: int, w: int,
                        block_size: int = 128) -> torch.Tensor:
    """All K taps in one launch: x (R, N) -> (K, R, N) = [x, xS, ...,
    xS^{K-1}] in x's dtype (f32 or bf16, each bf16 tap rounded before the
    next reads it), S in the band layout with n_cols == N.

    CUDA kernel: one cooperative launch, a grid barrier between taps, a
    slab panel resident in each block's shared memory for all taps,
    replacing the Pallas kernel of the JAX package's
    ``ops/spmm.py:band_shift_register``. In f32 ``band_register_kernel``
    in kernels/csrc/spmm.cu (FP32 FMAs on a 32-column panel). In bf16
    ``band_register_mma_kernel``: the panel in bf16 (64 columns above 64
    rows where it fits, else 32), the previous tap's slices staged by
    16-byte
    ``cp.async`` from L2 in a ring that runs across a block's items, the
    products on tensor cores (``mma.sync``, f32 accumulators); bound by
    the L2 reads of the previous taps and the K-2 grid barriers.
    """
    R, N = x.shape
    bs = block_size
    nb = _cdiv(n_cols, bs)
    if n_taps < 1:
        raise ValueError(f"band_shift_register: n_taps={n_taps} < 1")
    if N != n_cols:
        raise ValueError(f"band_shift_register: x has {N} columns, "
                         f"n_cols={n_cols}")
    if tuple(s_band.shape) != (nb, (2 * w + 1) * bs, bs):
        raise ValueError(f"band_shift_register: s_band "
                         f"{tuple(s_band.shape)} does not fit n_cols="
                         f"{n_cols}, w={w}, bs={bs}")
    if not kernels.on_cuda("band_shift_register", x, s_band) and \
            kernels.needs_grad(x, s_band):
        return band_shift_register_plain(x, s_band, n_taps=n_taps,
                                         n_cols=n_cols, w=w, block_size=bs)
    return _BAND_SHIFT_REGISTER(x, s_band, n_taps, n_cols, w, bs)


band_shift_register.launches = 0


def bcsr_col_start(block_col, n_cols: int, block_size: int = 128):
    """The first block of each output block column's segment, (nb + 1,)
    int32 with nb = ceil(n_cols / bs): column j's blocks are
    ``col_start[j]:col_start[j + 1]`` of a layout sorted by column. numpy
    in, numpy out (what a Gso caches with its layout); a tensor in, a
    tensor on its device out."""
    nb = _cdiv(n_cols, block_size)
    if isinstance(block_col, torch.Tensor):
        return torch.searchsorted(
            block_col, torch.arange(nb + 1, dtype=torch.int32,
                                    device=block_col.device),
            out_int32=True)
    return np.searchsorted(np.asarray(block_col),
                           np.arange(nb + 1)).astype(np.int32)


def bcsr_matmul(x: torch.Tensor, blocks: torch.Tensor,
                block_row: torch.Tensor, block_col: torch.Tensor, *,
                n_cols: int, block_size: int = 128,
                col_start: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ S with S in the BCSR layout: x (R, N), blocks (nnzb, bs,
    bs), block_row/block_col (nnzb,) int32 sorted by column -> y (R,
    n_cols), in x's dtype (f32 or bf16; blocks in the same). n_cols may
    differ from N: block_row indexes x's block columns, block_col the
    output's. Empty output columns are zero. col_start: the layout's
    segment offsets (:func:`bcsr_col_start`), as a Gso caches them;
    without it the CUDA path computes them on the card.

    CUDA kernel, replacing the Pallas kernel of the JAX package's
    ``ops/spmm.py:bcsr_matmul``: in f32 ``bcsr_matmul_kernel`` (and
    ``bcsr_narrow_kernel`` at most 64 rows) in kernels/csrc/spmm.cu, FP32
    FMAs; in bf16 ``bcsr_mma_kernel<., BcsrBlocks, bf16>``, the tensor-core
    mainloop :func:`band_matmul` describes.
    """
    R, N = x.shape
    bs = block_size
    nnzb = blocks.shape[0]
    if (tuple(blocks.shape) != (nnzb, bs, bs)
            or tuple(block_row.shape) != (nnzb,)
            or tuple(block_col.shape) != (nnzb,)):
        raise ValueError(f"bcsr_matmul: layout shapes {tuple(blocks.shape)}, "
                         f"{tuple(block_row.shape)}, "
                         f"{tuple(block_col.shape)} do not fit bs={bs}")
    nb = _cdiv(n_cols, bs)
    if col_start is not None and tuple(col_start.shape) != (nb + 1,):
        raise ValueError(f"bcsr_matmul: col_start {tuple(col_start.shape)} "
                         f"does not fit n_cols={n_cols}, bs={bs}")
    cached = () if col_start is None else (col_start,)
    if not kernels.on_cuda("bcsr_matmul", x, blocks, block_row, block_col,
                           *cached) and kernels.needs_grad(x, blocks):
        return bcsr_matmul_plain(x, blocks, block_row, block_col,
                                 n_cols=n_cols, block_size=bs)
    return _BCSR_MATMUL(x, blocks, block_row, block_col, col_start, n_cols,
                        bs)


bcsr_matmul.launches = 0


KERNEL_WRAPPERS = (band_matmul, band_shift_register, bcsr_matmul)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


# ---------------------------------------------------------------------------
# Differentiable shifts (the JAX package's custom VJPs)
# ---------------------------------------------------------------------------

class BandShift(torch.autograd.Function):
    """y = x @ S on the band slab; dx = g @ S^T on the transposed slab
    (JAX ``spmm.band_shift``). S is square: x (R, n_cols)."""

    @staticmethod
    def forward(ctx, x, s_band, s_band_t, n_cols: int, w: int,
                block_size: int = 128):
        ctx.s_band_t, ctx.cfg = s_band_t, (n_cols, w, block_size)
        return band_matmul(x, s_band, n_cols=n_cols, w=w,
                           block_size=block_size)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return (None,) * 6
        n_cols, w, bs = ctx.cfg
        dx = band_matmul(g.contiguous(), ctx.s_band_t, n_cols=n_cols, w=w,
                         block_size=bs)
        return dx, None, None, None, None, None


class BcsrShift(torch.autograd.Function):
    """y = x @ S on the BCSR blocks; dx = g @ S^T on the transposed layout
    (JAX ``spmm.bcsr_shift``). S is n_cols_in x n_cols: x (R, n_cols_in)
    -> y (R, n_cols); block_row indexes x's block columns, block_col the
    output's. n_cols_in None means a square S. A rectangular S is one
    shard's column slice of the global GSO (JAX ``spmm.bcsr_shift_rect``,
    the contraction of ``parallel.shift.sharded_gshift_bcsr``). col_start
    and col_start_t: the two layouts' cached segment offsets
    (:func:`bcsr_col_start`), or None."""

    @staticmethod
    def forward(ctx, x, blocks, block_row, block_col, blocks_t, block_row_t,
                block_col_t, n_cols: int, block_size: int = 128,
                col_start=None, col_start_t=None, n_cols_in=None):
        ctx.layout_t = (blocks_t, block_row_t, block_col_t, col_start_t)
        ctx.cfg = (n_cols if n_cols_in is None else n_cols_in, block_size)
        return bcsr_matmul(x, blocks, block_row, block_col, n_cols=n_cols,
                           block_size=block_size, col_start=col_start)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return (None,) * 12
        n_cols_in, bs = ctx.cfg
        blocks_t, block_row_t, block_col_t, col_start_t = ctx.layout_t
        dx = bcsr_matmul(g.contiguous(), blocks_t, block_row_t, block_col_t,
                         n_cols=n_cols_in, block_size=bs,
                         col_start=col_start_t)
        return (dx,) + (None,) * 11


def bcsr_shift_rect(x, blocks, block_row, block_col, blocks_t, block_row_t,
                    block_col_t, n_cols_out: int, n_cols_in: int,
                    block_size: int = 128, col_start=None, col_start_t=None):
    """:class:`BcsrShift` on a rectangular S (the JAX package's name)."""
    return BcsrShift.apply(x, blocks, block_row, block_col, blocks_t,
                           block_row_t, block_col_t, n_cols_out, block_size,
                           col_start, col_start_t, n_cols_in)


class BandRegister(torch.autograd.Function):
    """(R, N) -> (K, R, N) = [x, xS, ..., xS^{K-1}] in one launch of
    band_shift_register; backward dx = g_0 + (g_1 + (...) S^T) S^T, K-1
    band_matmuls on the transposed slab (JAX ``spmm.band_register``)."""

    @staticmethod
    def forward(ctx, x, s_band, s_band_t, n_taps: int, n_cols: int, w: int,
                block_size: int = 128):
        ctx.s_band_t, ctx.cfg = s_band_t, (n_taps, n_cols, w, block_size)
        return band_shift_register(x, s_band, n_taps=n_taps, n_cols=n_cols,
                                   w=w, block_size=block_size)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return (None,) * 7
        K, n_cols, w, bs = ctx.cfg
        g = g.contiguous()
        dx = g[K - 1]
        for k in range(K - 2, -1, -1):
            dx = band_matmul(dx, ctx.s_band_t, n_cols=n_cols, w=w,
                             block_size=bs) + g[k]
        return dx, None, None, None, None, None, None
