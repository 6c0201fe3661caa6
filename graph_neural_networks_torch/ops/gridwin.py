"""The cell-grid swarm environment's window and table kernels.

The port of the JAX package's ``ops/gridwin.py``. The grid env step
(``data.flocking.env_step_grid``) bins the agents into a modular grid of
cells and stores the cell table ONE ROW PER CELL, feature-blocked:

    row h = [px*C | py*C | vx*C | vy*C | valid*C | id*C | v*C | pay*C x P | 0]

lane f*C + c holding feature f of the cell's c-th member, W = (7+P)*C
rounded up to 128 lanes (the JAX table, bit for bit). Three kernels
(``kernels/csrc/gridwin.cu``), each behind a wrapper of the same name:

  * :func:`table_build` -- the table from the agents' feature rows sorted
    by cell and each cell's run start (the default, ``fused``, build).
  * :func:`table_transpose` -- member-major slot rows (H*C, L) to the
    feature-blocked table (the ``gather`` build's relayout).
  * :func:`grid_window` -- per agent, over its n_win candidate cell rows
    (read from the table by slot): the distance mask, the 6 masked state
    sums, wv = the masked sum of v (one power-iteration matvec), the
    in-degree, the first d_max neighbors in candidate order, and the masked
    sums of the payload features (the policy's register shift).

A wrapper runs its ``*_plain`` version when its inputs lie on the CPU and
launches its kernel when they lie on a CUDA device; it never falls back
from one to the other. Each launch adds one to the wrapper's ``launches``
count.

Where the port's operands differ from the TPU kernels': ``grid_window``
takes the table and each agent's window slots and keep mask instead of
the gathered (n_win, rows, W) candidate operand, and writes
``_out_width`` = 2*d_max + 8 + n_pay columns (no 128-lane padding);
``table_build`` takes the sorted features as (B, N, F) rows, batched, and
reads only each cell's run, so it needs no pad rows past N and on cell
overflow keeps the first C members, as the gather build does (the JAX
fused kernel's window can overrun there).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from graph_neural_networks_torch import kernels

ZERO_TOL = 1e-9
# The float32 values the kernels compare against (the JAX kernels compare
# f32 arrays with weakly typed Python floats, i.e. these values)
_TOL32 = float(np.float32(ZERO_TOL))
# exp(-d2) > ZERO_TOL  <=>  d2 < -ln(ZERO_TOL) (~20.7): below this r2 the
# exp test is implied by d2 <= r2, and the JAX kernel skips it statically
_EXP_FREE_R2 = -math.log(ZERO_TOL)
# grid_window: candidates an agent (n_win * C) at most (kMaxChunks * 32
# in gridwin.cu), and windows (one lane a window: kMaxWin)
MAX_CANDIDATES = 1024
MAX_WINDOWS = 32
# table_transpose on CUDA stages at least 4 cells, double buffered, in a
# block's 227 KB of shared memory: C * (F | 1) floats a cell at most
MAX_TRANSPOSE_CELL = 232448 // (2 * 4 * 4)


def table_width(n_feat: int, C: int) -> int:
    """Lanes of a table row: n_feat*C rounded up to a multiple of 128."""
    return -(-n_feat * C // 128) * 128


def _out_width(d_max: int, n_pay: int = 0) -> int:
    """Columns of grid_window's output: [idx | val | st(6) | wv | cnt |
    wpay]."""
    return 2 * d_max + 8 + n_pay


def _f32(x: float) -> float:
    return float(np.float32(x))


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the kernels' reference)
# ---------------------------------------------------------------------------

def _warp_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum (R, M) over M in the kernel's association: candidate j is lane
    j % 32 of chunk j // 32; each lane adds its chunks in order, then the
    xor-shuffle tree (offsets 16 .. 1) adds the lanes. Bit for bit what
    grid_window_kernel's per-lane accumulators and warp_sum give."""
    R, M = t.shape
    n_chunks = -(-M // 32)
    t = torch.nn.functional.pad(t, (0, n_chunks * 32 - M)).view(R, n_chunks,
                                                                32)
    acc = t[:, 0]
    for ch in range(1, n_chunks):
        acc = acc + t[:, ch]
    lane = torch.arange(32, device=t.device)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[:, lane ^ o]
    # contiguous, as the kernel's output: later reductions over it (the
    # power iteration's norms) associate by memory layout
    return acc[:, 0].contiguous()


def grid_window_plain(table: torch.Tensor, own: torch.Tensor,
                      slots: torch.Tensor, keep: torch.Tensor, *, C: int,
                      r2: float, d_max: int, wv_only: bool = False,
                      n_pay: int = 0) -> torch.Tensor:
    """:func:`grid_window`'s function: gather the candidate rows, then the
    JAX kernel's arithmetic (gridwin.py:_make_kernel), the same separate
    IEEE operations as the CUDA kernel and its sums in the kernel's order
    (:func:`_warp_sum`), so on the card the two agree bit for bit."""
    R, n_win = slots.shape
    W = table.shape[1]
    M = n_win * C
    r2 = _f32(r2)
    cand = table[slots.reshape(-1).long()].view(R, n_win, W)

    def fM(f):  # feature f of every candidate, lane order w*C + c
        return cand[:, :, f * C:(f + 1) * C].reshape(R, M)

    opx, opy, ovx, ovy, oid = (own[:, i:i + 1] for i in range(5))
    keep_m = keep.to(table.dtype).repeat_interleave(C, dim=1)
    valid = fM(4) * keep_m
    cid = fM(5)
    dpx, dpy = opx - fM(0), opy - fM(1)
    d2 = dpx * dpx + dpy * dpy
    m = (valid > 0) & (d2 <= r2) & (cid != oid)
    if r2 > _EXP_FREE_R2:
        m &= torch.exp(-d2) > _TOL32
    mf = m.to(table.dtype)
    wv = _warp_sum(fM(6) * mf)
    if wv_only:
        return wv[:, None]
    inv = torch.where(d2 > _TOL32, 1.0 / d2, torch.zeros_like(d2)) * mf
    st = [_warp_sum((ovx - fM(2)) * mf), _warp_sum((ovy - fM(3)) * mf),
          _warp_sum(dpx * inv * inv), _warp_sum(dpy * inv * inv),
          _warp_sum(dpx * inv), _warp_sum(dpy * inv)]
    cols = []
    if d_max:
        # rank t+1 (in candidate order) selects exactly one masked lane
        rank = torch.cumsum(m.to(torch.int32), dim=1)
        slot = torch.where(m & (rank <= d_max), rank - 1,
                           torch.full_like(rank, d_max)).long()
        sel = torch.zeros(R, d_max + 1, dtype=table.dtype,
                          device=table.device)
        sel.scatter_(1, slot, cid + 1.0)
        sel = sel[:, :d_max]
        cols = [torch.clamp_min(sel - 1.0, 0.0), (sel > 0).to(table.dtype)]
    cnt = _warp_sum(mf)
    cols += [torch.stack(st + [wv, cnt], dim=1)]
    if n_pay:
        cols.append(torch.stack([_warp_sum(fM(7 + p) * mf)
                                 for p in range(n_pay)], dim=1))
    return torch.cat(cols, dim=1)


def table_build_plain(fs: torch.Tensor, starts: torch.Tensor, *,
                      C: int) -> torch.Tensor:
    """:func:`table_build`'s function: fs (B, N, F), starts (B, H+1) ->
    (B, H, W)."""
    B, N, F = fs.shape
    H = starts.shape[1] - 1
    W = table_width(F, C)
    st = starts.long()
    run = torch.clamp(st[:, 1:] - st[:, :-1], max=C)              # (B, H)
    c = torch.arange(C, device=fs.device)
    src = st[:, :-1, None] + c                                     # (B, H, C)
    live = c < run[..., None]
    fs_z = torch.cat([fs, fs.new_zeros(B, 1, F)], dim=1)           # row N: 0
    src = torch.where(live, src, torch.full_like(src, N))
    rows = torch.gather(fs_z, 1, src.reshape(B, H * C, 1).expand(-1, -1, F))
    blocks = rows.view(B, H, C, F).transpose(2, 3).reshape(B, H, F * C)
    return torch.nn.functional.pad(blocks, (0, W - F * C))


def table_transpose_plain(mm: torch.Tensor, *, C: int,
                          F: int) -> torch.Tensor:
    """:func:`table_transpose`'s function: (H*C, L) -> (H, W)."""
    HC, L = mm.shape
    H = HC // C
    W = table_width(F, C)
    blocks = mm.view(H, C, L)[:, :, :F].transpose(1, 2).reshape(H, F * C)
    return torch.nn.functional.pad(blocks, (0, W - F * C))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def grid_window(table: torch.Tensor, own: torch.Tensor, slots: torch.Tensor,
                keep: torch.Tensor, *, C: int, r2: float, d_max: int,
                wv_only: bool = False, n_pay: int = 0) -> torch.Tensor:
    """The window pass of R agent rows against the cell table.

    table (cells, W) f32 feature-blocked; own (R, 5) [px, py, vx, vy, id]
    (id: the agent's index in its sample, as stored in the table); slots
    (R, n_win) int32, the table row of each of the agent's windows; keep
    (R, n_win) bool, False for a window that repeats an earlier one of the
    agent. Returns (R, 2*d_max + 8 + n_pay) f32: [idx (d_max, float ids,
    0-filled) | val (d_max, 0/1) | st (6) | wv | cnt | wpay (n_pay)], or
    (R, 1) = wv when wv_only. Masked: valid, d2 <= r2, id != own id, and
    exp(-d2) > 1e-9 when r2 > -ln(1e-9).

    CUDA kernel: ``grid_window_kernel`` in kernels/csrc/gridwin.cu,
    replacing the Pallas kernel of the JAX package's
    ``ops/gridwin.py:grid_window``.
    """
    R, n_win = slots.shape
    cells, W = table.shape
    if tuple(own.shape) != (R, 5) or tuple(keep.shape) != (R, n_win):
        raise ValueError(f"grid_window: own {tuple(own.shape)}, keep "
                         f"{tuple(keep.shape)} for {R} rows, {n_win} windows")
    if (7 + n_pay) * C > W or n_win * C > MAX_CANDIDATES:
        raise ValueError(f"grid_window: (7+{n_pay})*{C} lanes in a {W}-lane "
                         f"row, or {n_win}*{C} candidates > {MAX_CANDIDATES}")
    if not kernels.on_cuda("grid_window", table, own, slots, keep):
        return grid_window_plain(table, own, slots, keep, C=C, r2=r2,
                                 d_max=d_max, wv_only=wv_only, n_pay=n_pay)
    kernels.check_inputs("grid_window", table=(table, torch.float32),
                         own=(own, torch.float32), slots=(slots, torch.int32),
                         keep=(keep, torch.bool))
    if n_win > MAX_WINDOWS:
        raise ValueError(f"grid_window: the kernel takes {MAX_WINDOWS} "
                         f"windows an agent at most, got {n_win}")
    OW = 1 if wv_only else _out_width(d_max, n_pay)
    out = torch.empty((R, OW), dtype=torch.float32, device=table.device)
    if R == 0:
        return out
    err = kernels.library().gnt_grid_window(
        table.data_ptr(), own.data_ptr(), slots.data_ptr(), keep.data_ptr(),
        out.data_ptr(), R, W, n_win, C, _f32(r2), int(r2 > _EXP_FREE_R2),
        d_max, int(wv_only), n_pay, kernels.stream())
    kernels.check(err, "grid_window")
    grid_window.launches += 1
    return out


grid_window.launches = 0


def table_build(fs: torch.Tensor, starts: torch.Tensor, *,
                C: int) -> torch.Tensor:
    """The cell table from sorted feature rows, batched.

    fs (B, N, F): each sample's agents sorted by cell slot, row = the
    agent's F features; starts (B, H+1) int32: each cell's run start in
    fs[b] (starts[b, H] = N; empty cells have empty runs). Returns
    (B, H, W), out[b, h, f*C + c] = fs[b, starts[b, h] + c, f] for
    c < min(run, C), else 0. An overflowing run keeps its first C members.

    CUDA kernel: ``table_build_kernel`` in kernels/csrc/gridwin.cu,
    replacing the Pallas kernel of the JAX package's
    ``ops/gridwin.py:table_build``.
    """
    B, N, F = fs.shape
    H = starts.shape[1] - 1
    if starts.shape[0] != B or H < 1:
        raise ValueError(f"table_build: starts {tuple(starts.shape)} for "
                         f"fs {tuple(fs.shape)}")
    if not kernels.on_cuda("table_build", fs, starts):
        return table_build_plain(fs, starts, C=C)
    kernels.check_inputs("table_build", fs=(fs, torch.float32),
                         starts=(starts, torch.int32))
    W = table_width(F, C)
    out = torch.empty((B, H, W), dtype=torch.float32, device=fs.device)
    err = kernels.library().gnt_table_build(
        fs.data_ptr(), starts.data_ptr(), out.data_ptr(), B, H, N, F, C, W,
        kernels.stream())
    kernels.check(err, "table_build")
    table_build.launches += 1
    return out


table_build.launches = 0


def table_transpose(mm: torch.Tensor, *, C: int, F: int) -> torch.Tensor:
    """(H*C, L) member-major slot rows -> (H, W) feature-blocked cell rows,
    W = ceil(F*C/128)*128: out[h, f*C + c] = mm[h*C + c, f], lanes >= F*C
    zero (L >= F).

    CUDA kernel: ``table_transpose_kernel`` in kernels/csrc/gridwin.cu,
    replacing the Pallas kernel of the JAX package's
    ``ops/gridwin.py:table_transpose``.
    """
    HC, L = mm.shape
    if HC % C or not 0 < F <= L:
        raise ValueError(f"table_transpose: mm {tuple(mm.shape)}, C={C}, "
                         f"F={F}")
    if not kernels.on_cuda("table_transpose", mm):
        return table_transpose_plain(mm, C=C, F=F)
    kernels.check_inputs("table_transpose", mm=(mm, torch.float32))
    if C * (F | 1) > MAX_TRANSPOSE_CELL:
        raise ValueError(f"table_transpose: a cell of C={C} x F={F} floats "
                         f"exceeds the kernel's {MAX_TRANSPOSE_CELL}")
    H = HC // C
    W = table_width(F, C)
    out = torch.empty((H, W), dtype=torch.float32, device=mm.device)
    err = kernels.library().gnt_table_transpose(
        mm.data_ptr(), out.data_ptr(), H, L, F, C, W, kernels.stream())
    kernels.check(err, "table_transpose")
    table_transpose.launches += 1
    return out


table_transpose.launches = 0

KERNEL_WRAPPERS = (grid_window, table_build, table_transpose)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
