"""Flocking: a decentralized swarm controller trained by imitation of the
centralized expert and deployed closed loop.

The port of the JAX package's ``data/flocking.py``.

* The reference-scale dataset (``Flocking(...)``): the expert's
  trajectories, communication graphs and agent states generated in f64
  numpy on the host (``compute_optimal_trajectory``,
  ``compute_communication_graph``, ``compute_states``), served by
  ``getData``/``getSamples``; ``training.TrainerFlocking`` trains over it
  from its host store.
* Closed-loop rollouts (``compute_trajectory``, ``rollout_traj_device``,
  ``rollout_cost``) on one of three environments: the all-pairs step
  (:func:`comm_graph`, :func:`states`; the dense (B,T,N,N) graph
  trajectory, or its top-D ELL form), the chunked all-pairs step
  (``env_chunk``), or the O(N) cell-list grid (:func:`env_step_grid`)
  whose table and window passes run the kernels of ``ops/gridwin.py``.
* Large swarms: ``Flocking.large`` generates the expert's supervision on
  the grid (``env_grid``) or on the chunked all-pairs env (states, labels
  and ELL graphs, kept as host
  numpy); ``Flocking.large_device`` keeps only the expert's (pos, vel) on
  the device, and each training batch recomputes its states, labels and
  ELL graphs there (:func:`recompute_supervision_grid`; the dense
  :func:`recompute_supervision` serves a reference-scale dataset).

Device tensors are f32; rollouts are Python loops over steps, and the
grid's exactness flag ``ok`` stays on the device until a rollout ends.

A grid rollout runs fused (the policy's registers ride the cell table as
payload and the window pass shifts them) or unfused (the policy shifts
its registers over the ELL graph the step emitted); the rule is JAX's:
fused when the payload is at most 1.5 ell_degree columns wide.

The chunked all-pairs env (:func:`env_step_chunked`,
:func:`expert_accel_chunked`: row chunks against the whole swarm, O(B·
chunk·N) memory, plain torch as JAX's is XLA) serves ``Flocking.large``
without ``env_grid`` and the rollouts with ``env_chunk``. Besides the
step interface, a rollout runs the windowed re-forward (``step_mode=
False`` or a policy without ``rollout_step``: the full-history forward
over the last w steps) on any env, the grid and chunked ones also in host
segments (``seg=``); ``compute_trajectory`` also replays an open-loop
acceleration sequence and runs the host loop of a plain callable policy.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from graph_neural_networks_torch.data.base import (
    ZERO_TOL, Data, invert_tensor_ew)
from graph_neural_networks_torch.ops import gridwin
from graph_neural_networks_torch.ops.ell import (EllGso, ell_from_dense,
                                                 ell_shift, ell_topk)
from graph_neural_networks_torch.utils.device import resolve_device

# ---------------------------------------------------------------------------
# Dense all-pairs step: the reference for one environment step
# ---------------------------------------------------------------------------

def lambda_max_power(W: torch.Tensor, iters: int = 64) -> torch.Tensor:
    """Top eigenvalue of a symmetric nonnegative (B,N,N) matrix by power
    iteration from the all-ones vector."""
    B, N, _ = W.shape
    v = torch.ones((B, N), dtype=W.dtype, device=W.device) / math.sqrt(N)
    for _ in range(iters):
        w = torch.einsum("bnm,bn->bm", W, v)
        v = w / torch.clamp_min(
            torch.linalg.vector_norm(w, dim=-1, keepdim=True), ZERO_TOL)
    return torch.einsum("bn,bnm,bm->b", v, W, v)


def comm_graph(pos: torch.Tensor, comm_radius: float,
               lam_method: str = "eig"):
    """Dense communication graph (B,2,N) -> (B,N,N): unweighted, in range,
    no self loops, divided by lambda_max ('eig' or 'power'; the reference
    computeCommunicationGraph, dataTools.py:2816-3020)."""
    diff = pos[:, :, :, None] - pos[:, :, None, :]
    dist_sq = (diff ** 2).sum(1)
    Wk = torch.exp(-dist_sq)
    Wk = torch.where(dist_sq > comm_radius ** 2, torch.zeros_like(Wk), Wk)
    N = pos.shape[-1]
    eye = torch.eye(N, dtype=torch.bool, device=pos.device)
    Wk = torch.where(eye[None], torch.zeros_like(Wk), Wk)
    W = (Wk > ZERO_TOL).to(pos.dtype)
    if lam_method == "power":
        lam = lambda_max_power(W)
    else:
        lam = torch.linalg.eigvalsh(W).amax(-1)
    lam = torch.where(lam.abs() < ZERO_TOL, torch.ones_like(lam), lam)
    return W / lam[:, None, None]


def states(pos: torch.Tensor, vel: torch.Tensor,
           graph: torch.Tensor) -> torch.Tensor:
    """Dense 6-feature agent states (B,6,N) on the graph's support (the
    reference computeStates, dataTools.py:2612-2815)."""
    diff_pos = pos[:, :, :, None] - pos[:, :, None, :]
    dist_sq = (diff_pos ** 2).sum(1)
    diff_vel = vel[:, :, :, None] - vel[:, :, None, :]
    adj = (graph.abs() > ZERO_TOL).to(pos.dtype)[:, None]
    inv = torch.where(dist_sq.abs() > ZERO_TOL, 1.0 / dist_sq,
                      torch.zeros_like(dist_sq))
    inv = inv[:, None] * adj
    diff_pos = diff_pos * adj
    diff_vel = diff_vel * adj
    return torch.cat([diff_vel.sum(-1), (diff_pos * inv ** 2).sum(-1),
                      (diff_pos * inv).sum(-1)], dim=-2)


# ---------------------------------------------------------------------------
# Chunked all-pairs environment step: O(B·chunk·N) memory
# ---------------------------------------------------------------------------

def _fit_chunk(n: int, chunk: int) -> int:
    """Largest divisor of n that is <= chunk (the chunked env and expert
    require the row chunk to divide N exactly)."""
    chunk = max(min(int(chunk), n), 1)
    while n % chunk:
        chunk -= 1
    return chunk


def _topk_blocked(scores: torch.Tensor, k: int, block: int):
    """Exact top-k along the last axis in two stages (JAX
    ``_topk_blocked``): each block's top k, then the top k of the nb·k
    candidates; any global top-k element is in its own block's top k
    (k <= block). Stable sorts put equal scores in index order, as
    ``lax.top_k`` does (``torch.topk`` fixes no order among ties). On no
    env path: the general-scores utility beside :func:`_env_topk`.
    Requires N % block == 0. Returns (values, indices int64)."""
    *L, N = scores.shape
    nb = N // block
    s = scores.reshape(*L, nb, block)
    v1, i1 = torch.sort(s, dim=-1, descending=True, stable=True)
    v1, i1 = v1[..., :k], i1[..., :k]                 # (*L, nb, k)
    offs = torch.arange(nb, device=scores.device)[:, None] * block
    gidx = (i1 + offs).reshape(*L, nb * k)
    v2, i2 = torch.sort(v1.reshape(*L, nb * k), dim=-1, descending=True,
                        stable=True)
    return v2[..., :k], torch.gather(gidx, -1, i2[..., :k])


def _env_topk(m: torch.Tensor, d_max: int):
    """The first d_max set bits of each row of a binary mask (bool or
    {0, 1}), as (val, idx): the ``lax.top_k`` contract on {0, 1} (JAX
    ``_env_topk``): idx int32 ascending, val 1 or 0 (the mask's float
    dtype; f32 for a bool mask), and idx = 0 where val = 0.

    JAX forms a (..., N, d_max) candidate tensor that XLA fuses into its
    min-reduce; eager torch would hold it in memory. Here r = the running
    count of set bits and idx_d = the first position where r >= d + 1,
    which is the (d+1)-th set bit since r rises by one at each set bit
    and is otherwise flat; a row with fewer bits gets N there, which marks
    the slot empty. One (..., N) int32 workspace."""
    dtype = m.dtype if m.is_floating_point() else torch.float32
    m = m if m.dtype == torch.bool else m > 0
    N = m.shape[-1]
    r = torch.cumsum(m, dim=-1, dtype=torch.int32)
    want = torch.arange(1, d_max + 1, dtype=torch.int32, device=m.device)
    want = want.expand(*m.shape[:-1], d_max).contiguous()
    idx = torch.searchsorted(r, want, out_int32=True)
    valid = idx < N
    return valid.to(dtype), torch.where(valid, idx, 0)


def _chunk_env_rows(pos, vel, lo: int, hi: int, r2: float, d_max: int,
                    payload=None):
    """Rows lo .. hi of the all-pairs env against the whole swarm (pos/vel
    (B,2,N)): the in-range, no-self-loop binary mask (d2 <= r2, exp(-d2) >
    ZERO_TOL), its first d_max columns (idx (B,c,D) int32, val01 (B,c,D)),
    the 6 state features (B,6,c), the rows' true in-degree cnt (B,c) and,
    given a payload (B,N,P), the masked product M @ payload (B,c,P).

    Only (B, c, N) workspaces are held, never a (B, 2, c, N) product: the
    position sums are dot products of the x and y offsets with inv and
    inv^2 (``torch.einsum`` contracts them without forming the products),
    and the velocity sum is v_i·deg_i - (M v)_i, one (c, N) @ (N, 2)
    product. Each workspace is freed once its last use is done."""
    B, _, N = pos.shape
    pr, vr = pos[:, :, lo:hi], vel[:, :, lo:hi]
    dx = pr[:, 0, :, None] - pos[:, 0, None, :]          # B, c, N
    dy = pr[:, 1, :, None] - pos[:, 1, None, :]
    d2 = dx * dx
    d2 += dy * dy
    m = d2 <= r2
    e = torch.neg(d2)
    m &= e.exp_() > ZERO_TOL
    del e
    m.diagonal(offset=lo, dim1=1, dim2=2).fill_(False)  # no self loops
    val01, idx = _env_topk(m, d_max)
    cnt = m.sum(dim=-1)
    mf = m.to(pos.dtype)
    sv = (vr.transpose(1, 2) * cnt[..., None].to(pos.dtype)
          - torch.bmm(mf, vel.transpose(1, 2)))           # B, c, 2
    wpay = None if payload is None else torch.bmm(mf, payload.to(pos.dtype))
    del mf
    inv = torch.reciprocal(d2)
    inv.masked_fill_(~(d2 > ZERO_TOL), 0.0)
    del d2
    inv.masked_fill_(~m, 0.0)
    del m
    s2 = [torch.einsum("bcn,bcn->bc", dd, inv) for dd in (dx, dy)]
    inv.square_()
    s4 = [torch.einsum("bcn,bcn->bc", dd, inv) for dd in (dx, dy)]
    del inv, dx, dy
    st = torch.stack([sv[..., 0], sv[..., 1], s4[0], s4[1], s2[0], s2[1]],
                     dim=1)
    return idx, val01, st, cnt, wpay


def env_step_chunked(pos, vel, comm_radius, d_max, chunk, v_prev,
                     lam_iters: int = 8):
    """One O(N·deg)-memory environment step (JAX
    ``_jnp_env_step_chunked``): the ELL communication graph (the first
    d_max binary in-neighbors of each agent, in ascending index order,
    lambda_max-normalized) and the 6 state features, computed in row
    chunks of ``chunk`` agents (:func:`_chunk_env_rows`): no (N, N) matrix
    is formed (at N = 65536 one is 17.2 GB), only (B, chunk, N)
    workspaces.

    Equal to the dense step whenever d_max covers the largest in-degree.
    lambda_max is the ELL matvec's, by power iteration warm-started from
    v_prev (lam_iters iterations), so with d_max below an in-degree it is
    the truncated graph's, as in JAX. pos/vel (B,2,N), v_prev (B,N);
    requires N % chunk == 0. Returns (idx (B,N,D) int32, val_norm (B,N,D),
    states (B,6,N), v (B,N))."""
    B, _, N = pos.shape
    if N % chunk:
        raise ValueError(f"chunk {chunk} does not divide N = {N} "
                         "(_fit_chunk)")
    r2 = comm_radius ** 2
    idx = torch.empty((B, N, d_max), dtype=torch.int32, device=pos.device)
    val = pos.new_empty((B, N, d_max))
    st = pos.new_empty((B, 6, N))
    for lo in range(0, N, chunk):
        idx[:, lo:lo + chunk], val[:, lo:lo + chunk], st[..., lo:lo + chunk], \
            *_ = _chunk_env_rows(pos, vel, lo, lo + chunk, r2, d_max)
    lam, v = _ell_lambda(v_prev, _ell_matvec(idx, val), lam_iters)
    return idx, val / lam[:, None, None], st, v


def expert_accel_chunked(pos, vel, repel_dist, accel_max, chunk: int):
    """The centralized expert's acceleration in O(B·chunk·N) memory (JAX
    ``_jnp_expert_accel_chunked``): the velocity consensus is a global
    O(N) reduction, and the collision sum over the pairs with d2 <
    repel_dist^2 is taken in row chunks, each a dot product of the x and
    y offsets with the weights m·(inv^2 + inv), no (B,2,chunk,N) product
    formed. Requires N % chunk == 0. (B,2,N) -> (B,2,N)."""
    B, _, N = pos.shape
    if N % chunk:
        raise ValueError(f"chunk {chunk} does not divide N = {N} "
                         "(_fit_chunk)")
    r2 = repel_dist ** 2
    rep = pos.new_empty((B, 2, N))
    for lo in range(0, N, chunk):
        pr = pos[:, :, lo:lo + chunk]
        dx = pr[:, 0, :, None] - pos[:, 0, None, :]      # B, c, N
        dy = pr[:, 1, :, None] - pos[:, 1, None, :]
        d2 = dx * dx
        d2 += dy * dy
        inv = torch.reciprocal(d2)
        inv.masked_fill_(~(d2 > ZERO_TOL), 0.0)
        w = inv * inv
        w += inv                                      # inv^2 + inv
        del inv
        w.masked_fill_(~(d2 < r2), 0.0)
        del d2
        for k, dd in enumerate((dx, dy)):
            rep[:, k, lo:lo + chunk] = 2.0 * torch.einsum("bcn,bcn->bc",
                                                          dd, w)
        del dx, dy, w
    return _expert_from_repel(vel, rep, accel_max)


# ---------------------------------------------------------------------------
# Cell-grid environment step
# ---------------------------------------------------------------------------

def _grid_geometry(N, table_size, cell_cap, factor: int = 1):
    """(H, Gx, Gy, C): modular-grid dims (H = Gx*Gy slots, a power of 2).
    factor = cell side in units of comm_radius: 1 -> 3x3 windows of side-r
    cells; 2 -> 2x2 windows of side-2r cells."""
    if table_size is not None:
        H = int(table_size)
    else:
        n_cells = max(N // (factor * factor), 1024)
        H = 1 << (n_cells - 1).bit_length()       # ~N/f^2, power of 2
    if H & (H - 1):
        raise ValueError(f"table_size must be a power of two, got {H}")
    k2 = H.bit_length() - 1
    Gx = 1 << ((k2 + 1) // 2)
    return H, Gx, H // Gx, int(cell_cap)


def _parse_env_grid(env_grid):
    """(table_size, cell_cap, cell_factor) from an env_grid spec: True ->
    the quad scheme defaults (None, 32, 2); a (table_size, cell_cap) pair
    keeps the 3x3 side-r scheme (factor 1); a 3-tuple sets the factor."""
    if env_grid is True:
        return None, 32, 2
    tup = tuple(env_grid)
    if len(tup) == 2:
        return tup[0], tup[1], 1
    return tup


def _grid_hash(cx: torch.Tensor, cy: torch.Tensor, Gx: int,
               Gy: int) -> torch.Tensor:
    """Modular toroidal cell -> slot: collision-free while the swarm's
    extent stays under Gx*side x Gy*side."""
    return (torch.remainder(cx, Gx)
            + Gx * torch.remainder(cy, Gy)).to(torch.int32)


def _grid_build_table(px, py, vx, vy, inv_s, H, Gx, Gy, C, v=None,
                      pay=None, builder: str = "fused"):
    """Bin each sample's agents into its cell table.

    px..vy (B,N); v (B,N) fills the 7th feature block (the power-iteration
    vector the window pass folds into one W @ v matvec); pay (B,N,P) fills
    P further blocks (the policy's tap registers). Returns (cell_rows
    (B,H,W), cx (B,N), cy (B,N), ok (B,), (order, vpos)): ok is False
    where a cell overflowed C; vpos (B,N) is the flat position in
    cell_rows[b] of each SORTED agent's v lane, so a later pass rewrites v
    in place with ``cell_rows.view(B, -1).scatter_(1, vpos, v[order])``.

    builder: 'fused' (the table_build kernel; the default), 'gather'
    (run starts by searchsorted, one row gather of every slot, the
    table_transpose kernel) or 'scatter' (plain torch). All three give the
    same table bit for bit whenever ok. No Flocking entry point takes a
    builder: 'gather' is reachable only through ``env_step_grid(builder=)``
    and is kept as the counterpart of the JAX package's gather build.
    """
    B, N = px.shape
    # ids travel through the float table: exact only below 2^24
    if N >= 2 ** 24:
        raise ValueError(f"grid env stores agent ids in float32 cells; "
                         f"N={N} >= 2^24 would corrupt neighbor ids")
    dev = px.device
    P = 0 if pay is None else pay.shape[-1]
    F_n = 7 + P
    W = gridwin.table_width(F_n, C)
    cx = torch.floor(px * inv_s).to(torch.int32)
    cy = torch.floor(py * inv_s).to(torch.int32)
    # a stable sort: a cell's member order sets the slot order, the first
    # d_max neighbor ids and the association of every window sum
    hs, order = torch.sort(_grid_hash(cx, cy, Gx, Gy), dim=1, stable=True)
    iota = torch.arange(N, dtype=torch.int32, device=dev).expand(B, N)
    flag = torch.ones_like(hs, dtype=torch.bool)
    flag[:, 1:] = hs[:, 1:] != hs[:, :-1]
    seg_start = torch.cummax(torch.where(flag, iota, 0), dim=1).values
    rank = iota - seg_start                 # rank within the cell's run
    ok = rank.amax(dim=1) < C
    feats = [px, py, vx, vy, torch.ones_like(px), iota.to(px.dtype),
             torch.zeros_like(px) if v is None else v]
    f = torch.stack(feats, dim=-1)
    if P:
        f = torch.cat([f, pay.to(px.dtype)], dim=-1)
    fs = torch.gather(f, 1, order[..., None].expand(B, N, F_n))
    base = hs.long() * W + torch.clamp(rank, max=C - 1)
    vpos = base + 6 * C
    if builder == "fused":
        counts = torch.zeros((B, H), dtype=torch.int32, device=dev)
        counts.scatter_add_(1, hs.long(), torch.ones_like(hs))
        starts = torch.zeros((B, H + 1), dtype=torch.int32, device=dev)
        starts[:, 1:] = torch.cumsum(counts, dim=1)
        cell_rows = gridwin.table_build(fs, starts, C=C)
    elif builder == "gather":
        cells = torch.arange(H, dtype=hs.dtype, device=dev).expand(B, H)
        starts = torch.searchsorted(hs, cells.contiguous(), out_int32=True)
        counts = torch.cat([starts[:, 1:], torch.full_like(starts[:, :1], N)],
                           dim=1) - starts
        c = torch.arange(C, dtype=torch.int32, device=dev)
        src = torch.where(c < torch.clamp(counts, max=C)[..., None],
                          starts[..., None] + c, N)          # N: zero row
        fs_z = torch.cat([fs, fs.new_zeros(B, 1, F_n)], dim=1)
        mm = torch.gather(fs_z, 1, src.reshape(B, H * C, 1).long()
                          .expand(B, H * C, F_n))
        cell_rows = gridwin.table_transpose(
            mm.reshape(B * H * C, F_n), C=C, F=F_n).view(B, H, W)
    elif builder == "scatter":
        pos = base[..., None] + torch.arange(F_n, device=dev) * C
        cell_rows = torch.zeros((B, H * W), dtype=px.dtype, device=dev)
        cell_rows.scatter_(1, pos.reshape(B, -1), fs.reshape(B, -1))
        cell_rows = cell_rows.view(B, H, W)
    else:
        raise ValueError(f"unknown table builder {builder!r}")
    return cell_rows, cx, cy, ok, (order, vpos)


def _window_operands(px, py, vx, vy, cx, cy, H, Gx, Gy, inv_s=None,
                     factor: int = 1, lo: int = 0):
    """grid_window's per-agent operands for all B*N agents: own (B*N, 5)
    [px, py, vx, vy, id], slots (B*N, n_win) the table rows (b*H + slot)
    of the agent's windows, keep (B*N, n_win). The agents may be the rows
    lo .. lo + N of a larger swarm whose table this is (one shard's rows,
    ``parallel.swarm``): their ids are then lo + 0 .. N - 1.

    factor 1: the agent's 3x3 cell neighborhood (side-r cells, 9 windows);
    factor >= 2: the 2x2 window based at floor((x - r)/s) of side
    factor*r cells (needs inv_s = 1/(factor*r)). The windows' order (that
    of ``offs``) is the candidate order of the first-d_max selection.
    """
    B, N = px.shape
    dev = px.device
    if factor == 1:
        offs = [(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)]
        ax, ay = cx, cy
    else:
        offs = [(dx, dy) for dx in (0, 1) for dy in (0, 1)]
        ax = torch.floor(px * inv_s - 1.0 / factor).to(torch.int32)
        ay = torch.floor(py * inv_s - 1.0 / factor).to(torch.int32)
    offs = torch.tensor(offs, dtype=torch.int32, device=dev)
    n_win = offs.shape[0]
    h9 = _grid_hash(ax[..., None] + offs[:, 0], ay[..., None] + offs[:, 1],
                    Gx, Gy)                                # (B, N, n_win)
    # drop a window the modular map aliased onto an earlier one of the
    # same agent: its candidates would count twice
    earlier = torch.ones((n_win, n_win), dtype=torch.bool,
                         device=dev).tril(-1)
    keep = ~((h9[..., :, None] == h9[..., None, :]) & earlier).any(-1)
    b_off = torch.arange(B, dtype=torch.int32, device=dev) * H
    slots = (h9 + b_off[:, None, None]).reshape(B * N, n_win)
    ids = torch.arange(lo, lo + N, dtype=px.dtype, device=dev).expand(B, N)
    own = torch.stack([px, py, vx, vy, ids], dim=-1).reshape(B * N, 5)
    return own, slots, keep.reshape(B * N, n_win)


def _grid_rows(px, py, vx, vy, cx, cy, cell_rows, Gx, Gy, C, r2, d_max,
               wv_only: bool = False, inv_s=None, factor: int = 1,
               n_pay: int = 0, lo: int = 0):
    """The window pass of all B*N agents against their samples' cell
    tables (B, H, W), in one grid_window launch; lo: the agents are rows
    lo .. lo + N of the swarm the tables hold (:func:`_window_operands`).

    Returns wv (B,N) when wv_only, else (idx (B,N,d_max) int32, val01
    (B,N,d_max), states (B,6,N), wv (B,N), cnt (B,N) the true in-degree,
    wpay (B,N,n_pay) the masked sums of the payload blocks).
    """
    B, N = px.shape
    H, W = cell_rows.shape[1:]
    own, slots, keep = _window_operands(px, py, vx, vy, cx, cy, H, Gx, Gy,
                                        inv_s, factor, lo)
    out = gridwin.grid_window(cell_rows.view(B * H, W), own, slots, keep,
                              C=C, r2=r2, d_max=d_max, wv_only=wv_only,
                              n_pay=n_pay)
    if wv_only:
        return out[:, 0].view(B, N)
    D = d_max
    out = out.view(B, N, -1)
    return (out[..., :D].to(torch.int32), out[..., D:2 * D],
            out[..., 2 * D:2 * D + 6].transpose(1, 2), out[..., 2 * D + 6],
            out[..., 2 * D + 7], out[..., 2 * D + 8:])


def _check_repel(repel_dist, comm_radius) -> None:
    """The cells are sized by comm_radius: a larger repel radius would drop
    collision pairs outside the windows."""
    if float(repel_dist) > float(comm_radius):
        raise ValueError(f"repel_dist {repel_dist} exceeds comm_radius "
                         f"{comm_radius}: the cells are sized by the latter")


def _repel_sums(px, py, vx, vy, cx, cy, cell_rows, Gx, Gy, C, repel_dist,
                inv_s, factor) -> torch.Tensor:
    """The expert's collision sums (B,2,N): one window pass over the table
    at r2 = repel_dist^2, d_max = 1, whose dp*inv and dp*inv^2 state
    columns give rep = 2*(st2 + st4, st3 + st5). It reads no v lane."""
    st = _grid_rows(px, py, vx, vy, cx, cy, cell_rows, Gx, Gy, C,
                    float(repel_dist) ** 2, 1, inv_s=inv_s, factor=factor)[2]
    return 2.0 * torch.stack([st[:, 2] + st[:, 4], st[:, 3] + st[:, 5]], dim=1)


def env_step_grid(pos, vel, comm_radius, d_max, v_prev, lam_iters: int = 8,
                  table_size=None, cell_cap: int = 16,
                  lam_path: str = "auto", cell_factor: int = 1,
                  payload=None, builder: str = "fused", expert_repel=None,
                  in_degree: bool = False):
    """One O(N·k) cell-list environment step (JAX ``_jnp_env_step_grid``).

    Agents are binned into square cells of side cell_factor*comm_radius
    on a modular grid of ``table_size`` cells; each agent's neighbors lie
    in its n_win candidate cells. Exact against the all-pairs step whenever
    no cell overflows ``cell_cap`` and d_max covers the true max in-degree
    (the returned ``ok`` says whether they did); neighbor order within a
    row follows the candidate windows.

    lambda_max, lam_path 'auto' or 'window': the main window pass folds
    one power-iteration matvec W @ v_prev (v_prev rides the table's 7th
    block). lam_iters=0 takes the Rayleigh quotient v_prev'Wv_prev /
    v_prev'v_prev and advances v one iteration; lam_iters >= 1 runs that
    many further window passes (``wv_only``), each after rewriting the
    table's v lanes in place. lam_path 'ell': lam_iters power iterations
    from v_prev over the emitted ELL graph (:func:`_ell_lambda`;
    lam_iters=0 keeps v_prev), no payload; the one-shard form of the
    sharded env's lambda at d_max > 0 (``parallel.swarm``).

    expert_repel=repelDist (<= comm_radius, so the windows cover every
    repel-range pair): a SECOND window pass over the same table at r2 =
    repelDist^2, d_max = 1, run before any lambda pass rewrites the v
    lanes; its states are the centralized expert's collision sums, and the
    step also returns rep = 2*(st2 + st4, st3 + st5) (B,2,N). It equals
    :func:`expert_accel`'s pairwise sum up to float association and the
    boundary comparator: d2 <= repel^2 here, < there. in_degree=True also
    returns each sample's largest true in-degree (B,) int32, the main
    pass's count of in-range neighbors before any d_max cut.

    pos/vel (B,2,N), v_prev (B,N), payload (B,N,P) or None. Returns (idx
    (B,N,D) int32, val_norm (B,N,D), states (B,6,N), v (B,N), [shifted
    (B,N,P) = (W/lambda) @ payload,] [rep (B,2,N),] [deg (B,),] ok ()), ok
    a 0-d bool
    tensor on the device. With a payload and d_max > 0, ok also requires
    every in-degree <= d_max (the payload shift is untruncated, the emitted
    graph is not).
    """
    if lam_path not in ("auto", "window", "ell"):
        raise ValueError(f"unknown lam_path {lam_path!r}: 'auto', 'window' "
                         "or 'ell'")
    ell_lam = lam_path == "ell"
    if ell_lam and payload is not None:
        raise ValueError("the fused payload shift rides the window-lambda "
                         "pass (lam_path 'auto'/'window')")
    if expert_repel is not None:
        _check_repel(expert_repel, comm_radius)
    B, _, N = pos.shape
    H, Gx, Gy, C = _grid_geometry(N, table_size, cell_cap, cell_factor)
    r2 = comm_radius ** 2
    inv_s = 1.0 / (cell_factor * comm_radius)
    P = 0 if payload is None else int(payload.shape[-1])
    px, py, vx, vy = pos[:, 0], pos[:, 1], vel[:, 0], vel[:, 1]
    cell_rows, cx, cy, ok, (order, vpos) = _grid_build_table(
        px, py, vx, vy, inv_s, H, Gx, Gy, C, v=None if ell_lam else v_prev,
        pay=payload, builder=builder)
    rows = lambda **kw: _grid_rows(px, py, vx, vy, cx, cy, cell_rows, Gx,
                                   Gy, C, r2, d_max, inv_s=inv_s,
                                   factor=cell_factor, **kw)
    idx, val, st, wv, cnt, wpay = rows(n_pay=P)
    if P and d_max > 0:
        ok = ok & (cnt.amax(dim=1) <= d_max)
    rep = None
    if expert_repel is not None:
        rep = _repel_sums(px, py, vx, vy, cx, cy, cell_rows, Gx, Gy, C,
                          expert_repel, inv_s, cell_factor)
    if ell_lam:
        lam, v = _ell_lambda(v_prev, _ell_matvec(idx, val), lam_iters)
    else:
        flat = cell_rows.view(B, -1)

        def matvec(vb):
            # the next step rebuilds the table, so its v lanes are
            # rewritten in place
            flat.scatter_(1, vpos, torch.gather(vb, 1, order))
            return rows(wv_only=True)

        lam, v = _window_lambda(v_prev, wv, matvec, lam_iters)
    out = (idx, val / lam[:, None, None], st, v)
    if P:
        out = out + (wpay / lam[:, None, None],)
    if rep is not None:
        out = out + (rep,)
    if in_degree:
        out = out + (cnt.amax(dim=1).to(torch.int32),)
    return out + (ok.all(),)


def _normalize(w: torch.Tensor) -> torch.Tensor:
    """w / max(||w||, ZERO_TOL) along the last axis."""
    return w / torch.clamp_min(
        torch.linalg.vector_norm(w, dim=-1, keepdim=True), ZERO_TOL)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def _lam_or_one(lam: torch.Tensor) -> torch.Tensor:
    """lambda_max with a zero (an edgeless graph) replaced by 1."""
    return torch.where(lam.abs() < ZERO_TOL, torch.ones_like(lam), lam)


def _window_lambda(v_prev, wv, matvec, lam_iters: int, nrm=_normalize,
                   dot=_dot):
    """lambda_max by window passes (env_step_grid's 'window' path): wv =
    W @ v_prev came with the main pass; lam_iters=0 takes the Rayleigh
    quotient of v_prev and v = nrm(wv); else lam_iters - 1 normalized
    ``matvec``s from nrm(wv) and lam = v'(matvec v). nrm and dot act on
    whatever holds v (a (B,N) tensor, or the sharded env's list of
    blocks). Returns (lam (B,), v)."""
    v = nrm(wv)
    if lam_iters == 0:
        lam = dot(v_prev, wv) / torch.clamp_min(dot(v_prev, v_prev),
                                                ZERO_TOL)
    else:
        for _ in range(lam_iters - 1):
            v = nrm(matvec(v))
        lam = dot(v, matvec(v))
    return _lam_or_one(lam), v


def _ell_lambda(v_prev, matvec, lam_iters: int, nrm=_normalize, dot=_dot):
    """lambda_max by warm-started power iteration (JAX
    ``_ell_power_lambda``): lam_iters normalized ``matvec``s from v_prev,
    then lam = v'(matvec v); nrm and dot as in :func:`_window_lambda`.
    Returns (lam (B,), v)."""
    v = v_prev
    for _ in range(lam_iters):
        v = nrm(matvec(v))
    return _lam_or_one(dot(v, matvec(v))), v


def _ell_matvec(idx, val):
    """v (B,N) -> W @ v on an ELL graph's (B,No,D) idx/val rows."""
    ell = EllGso(idx, val[:, None])
    return lambda v: ell_shift(v[:, None, None, :], ell)[:, 0, 0]


# ---------------------------------------------------------------------------
# The centralized expert and the training-batch supervision
# ---------------------------------------------------------------------------

def _velocity_term(vel: torch.Tensor) -> torch.Tensor:
    """The expert's velocity consensus -sum_j (v_i - v_j) = -(N v_i -
    sum v), a global O(N) reduction; vel (B,2,N)."""
    N = vel.shape[-1]
    return -(N * vel - vel.sum(dim=-1, keepdim=True))


def _expert_from_repel(vel: torch.Tensor, rep: torch.Tensor,
                       accel_max: float) -> torch.Tensor:
    """The expert's acceleration from its collision sums rep (B,2,N): the
    velocity consensus plus rep, clipped at +-accel_max."""
    return torch.clamp(_velocity_term(vel) + rep, -accel_max, accel_max)


def expert_accel(pos: torch.Tensor, vel: torch.Tensor, repel_dist: float,
                 accel_max: float) -> torch.Tensor:
    """The centralized expert's acceleration from all pairs (B,2,N) ->
    (B,2,N): velocity consensus plus the collision-avoidance sum over the
    pairs with d2 < repel_dist^2 (JAX ``_jnp_expert_accel_chunked``, one
    chunk; reference dataTools.py:3406-3507). The plain reference of
    :func:`expert_accel_grid` and of the recompute's labels; O(N^2)."""
    dp = pos[:, :, :, None] - pos[:, :, None, :]          # B,2,N,N
    d2 = (dp ** 2).sum(1)
    m = (d2 < repel_dist ** 2).to(pos.dtype)
    inv = torch.where(d2 > ZERO_TOL, 1.0 / d2, torch.zeros_like(d2))
    w = (m * (inv ** 2 + inv))[:, None]
    return _expert_from_repel(vel, 2.0 * (dp * w).sum(-1), accel_max)


def expert_accel_grid(pos: torch.Tensor, vel: torch.Tensor,
                      comm_radius: float, repel_dist: float,
                      accel_max: float, table_size=None, cell_cap: int = 32,
                      factor: int = 2):
    """The centralized expert's acceleration on the cell grid, O(N): the
    environment's cell geometry (sized by comm_radius >= repel_dist), one
    window pass at r2 = repel_dist^2 whose dp*inv and dp*inv^2 columns are
    the collision sums, and the global velocity term. Returns (accel
    (B,2,N), ok 0-d: False iff a cell overflowed cell_cap). Equals
    :func:`expert_accel` up to float association and the d2 == repel^2
    comparator (JAX ``_jnp_expert_accel_grid``)."""
    _check_repel(repel_dist, comm_radius)
    B, _, N = pos.shape
    H, Gx, Gy, C = _grid_geometry(N, table_size, cell_cap, factor)
    inv_s = 1.0 / (factor * comm_radius)
    px, py, vx, vy = pos[:, 0], pos[:, 1], vel[:, 0], vel[:, 1]
    cell_rows, cx, cy, ok, _ = _grid_build_table(px, py, vx, vy, inv_s, H,
                                                 Gx, Gy, C)
    rep = _repel_sums(px, py, vx, vy, cx, cy, cell_rows, Gx, Gy, C,
                      repel_dist, inv_s, factor)
    return _expert_from_repel(vel, rep, accel_max), ok.all()


# the expert's clip in the generated supervision: the reference expert's
# default (dataTools.py:3406), as the JAX generators use it
EXPERT_ACCEL_MAX = 100.0


def compute_differences(u: np.ndarray):
    """Pairwise differences u_i - u_j and squared distances, host numpy:
    u (S, 2, N) or (S, T, 2, N) -> diff (S, [T,] 2, N, N), dist_sq
    (S, [T,] N, N) (reference dataTools.py:3341-3404)."""
    squeeze = u.ndim == 3
    if squeeze:
        u = u[:, None]
    diff = u[..., :, None] - u[..., None, :]          # S x T x 2 x N x N
    dist_sq = np.sum(diff ** 2, axis=-3)              # S x T x N x N
    if squeeze:
        return diff[:, 0], dist_sq[:, 0]
    return diff, dist_sq


def expert_accel_host(pos: np.ndarray, vel: np.ndarray, repel_dist: float,
                      accel_max: float) -> np.ndarray:
    """The centralized expert's acceleration in f64 numpy on (..., 2, N)
    positions and velocities: minus the velocity differences' sum plus the
    collision-avoidance sum over the pairs closer than repel_dist, clipped
    at accel_max. (..., 2, N)."""
    diff_pos, dist_sq = compute_differences(pos)
    diff_vel, _ = compute_differences(vel)
    repel = (dist_sq < repel_dist ** 2).astype(np.float64)
    diff_pos = diff_pos * repel[..., None, :, :]
    inv = invert_tensor_ew(dist_sq)[..., None, :, :]
    accel = (-np.sum(diff_vel, axis=-1)
             + 2 * np.sum(diff_pos * (inv ** 2 + inv), axis=-1))
    return np.clip(accel, -accel_max, accel_max)


@torch.no_grad()
def recompute_supervision(pos: torch.Tensor, vel: torch.Tensor,
                          comm_radius: float, repel_dist: float,
                          accel_max: float, lam_method: str = "eig"):
    """A reference-scale training batch's supervision recomputed on the
    device from its (pos, vel) trajectories (B,T,2,N) alone, all pairs
    (JAX ``_jnp_recompute_supervision``): (states (B,T,6,N), expert accel
    (B,T,2,N) with accel[T-1] zeroed, normalized graphs (B,T,N,N)). Equals
    the host generation to f32 rounding."""
    B, T, _, N = pos.shape
    pf, vf = pos.reshape(B * T, 2, N), vel.reshape(B * T, 2, N)
    S = comm_graph(pf, comm_radius, lam_method)
    x = states(pf, vf, S).reshape(B, T, 6, N)
    y = expert_accel(pf, vf, repel_dist, accel_max).reshape(B, T, 2, N)
    y[:, T - 1] = 0.0
    return x, y, S.reshape(B, T, N, N)


@torch.no_grad()
def recompute_supervision_grid(pos: torch.Tensor, vel: torch.Tensor,
                               comm_radius: float, repel_dist: float,
                               accel_max: float, d_max: int, grid,
                               lam_iters: int = 1):
    """Everything a training batch needs, recomputed on the device from its
    (pos, vel) trajectories alone (JAX ``_jnp_recompute_supervision_grid``):
    (states (B,T,6,N), expert accel (B,T,2,N), the ELL graphs as an EllGso
    (idx (B,T,N,D), val (B,T,1,N,D)), ok 0-d, deg 0-d int32: the largest
    true in-degree over the batch).

    Each step is one grid env step with the expert's repel pass
    (:func:`env_step_grid` with ``expert_repel``); the lambda eigenvector
    is carried across t (t = 0 cold-starts at max(lam_iters, 32) passes).
    ``accel_max`` is the expert's clip (EXPERT_ACCEL_MAX for the generated
    labels); accel[T-1] is zeroed, the reference convention (it never
    drives a transition inside the horizon). ``ok`` covers cell
    overflow only, as in the JAX package: the emitted graphs are the
    first-d_max truncation of the untruncated neighbor sums wherever an
    in-degree exceeds d_max, which ``deg > d_max`` tells (the trainer's
    coverage check reads it).
    """
    gts, gcc, gcf = _parse_env_grid(grid)
    B, T, _, N = pos.shape
    D = min(int(d_max), N)
    dev, dt = pos.device, pos.dtype
    x = torch.empty((B, T, 6, N), dtype=dt, device=dev)
    y = torch.empty((B, T, 2, N), dtype=dt, device=dev)
    gi = torch.empty((B, T, N, D), dtype=torch.int32, device=dev)
    gv = torch.empty((B, T, 1, N, D), dtype=dt, device=dev)
    v = torch.ones((B, N), dtype=dt, device=dev) / math.sqrt(N)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    deg = torch.zeros((), dtype=torch.int32, device=dev)
    for t in range(T):
        pos_t, vel_t = pos[:, t], vel[:, t]
        i_t, s_t, x_t, v, rep, deg_t, ok_t = env_step_grid(
            pos_t, vel_t, comm_radius, D, v,
            lam_iters=max(lam_iters, 32) if t == 0 else lam_iters,
            table_size=gts, cell_cap=gcc, cell_factor=gcf,
            expert_repel=repel_dist, in_degree=True)
        x[:, t], gi[:, t], gv[:, t, 0] = x_t, i_t, s_t
        y[:, t] = _expert_from_repel(vel_t, rep, accel_max)
        ok = ok & ok_t
        deg = torch.maximum(deg, deg_t.amax())
    y[:, T - 1] = 0.0
    return x, y, EllGso(gi, gv), ok, deg


def evaluate_cost_device(vel: torch.Tensor) -> torch.Tensor:
    """``Flocking.evaluate``'s velocity-variance cost on the device: vel
    (B,T,2,N) -> 0-d tensor (mean over samples of the summed per-step
    mean-squared deviation from the swarm-average velocity)."""
    d = vel - vel.mean(dim=3, keepdim=True)
    c_t = (d * d).sum(2).mean(2)                          # (B, T)
    return c_t.sum(1).mean()


def _windows(parts, w: int):
    """Zero history windows (B, w, ...) of step 0's tensors (B, ...), each
    with step 0 in the last slot: the windowed re-forward's start."""
    out = []
    for a in parts:
        h = a.new_zeros((a.shape[0], w) + tuple(a.shape[1:]))
        h[:, -1] = a
        out.append(h)
    return tuple(out)


def _roll_windows(hists, news):
    """Each (B, w, ...) window shifted one step back, the new step's
    (B, ...) tensor in its last slot."""
    return tuple(torch.cat([h[:, 1:], n[:, None]], dim=1)
                 for h, n in zip(hists, news))


def _grid_warning(ok, strict: bool) -> None:
    """Surface the grid's exactness flag (one device read)."""
    if bool(ok):
        return
    msg = ("grid env: a hash cell overflowed cell_cap during the rollout "
           "(raise cell_cap/table_size), or some agent's in-degree exceeded "
           "d_max (raise ell_degree): neighbor sets / emitted graphs, and "
           "an unfused policy's shifts over them, may be incomplete")
    if strict:
        raise RuntimeError(msg)
    warnings.warn(msg, RuntimeWarning)


class Flocking(Data):
    """The flocking task (reference dataTools.py:2210-4005): the expert-
    supervised dataset, the closed-loop rollouts of a policy and the
    velocity-variance cost.

    ``Flocking(...)`` generates the reference-scale dataset on the host in
    f64 numpy (the expert's trajectories, the normalized dense graphs
    (n, T, N, N) and the 6-feature states), cast to ``dataType``;
    :meth:`for_rollout` builds the environment alone, :meth:`large` and
    :meth:`large_device` the large-swarm training sets. Rollouts run on
    ``device`` (CUDA unless the caller asks for the CPU).
    """

    def __init__(self, nAgents, commRadius, repelDist, nTrain, nValid, nTest,
                 duration, samplingTime, initGeometry="circular",
                 initVelValue=3.0, initMinDist=0.1, accelMax=10.0,
                 normalizeGraph=True, doPrint=False, dataType=np.float64,
                 rng=None, device="cuda"):
        self._init_env(nAgents, commRadius, repelDist, samplingTime,
                       initGeometry, initVelValue, initMinDist, accelMax,
                       normalizeGraph, doPrint, dataType, rng, device)
        self.nTrain, self.nValid, self.nTest = nTrain, nValid, nTest
        self.duration = float(duration)
        n_samples = nTrain + nValid + nTest
        init_pos, init_vel = self.compute_initial_positions(
            nAgents, n_samples, commRadius, minDist=initMinDist,
            geometry=initGeometry, xMaxInitVel=initVelValue,
            yMaxInitVel=initVelValue)
        pos, vel, accel = self.compute_optimal_trajectory(
            init_pos, init_vel, self.duration, samplingTime, repelDist,
            accelMax=accelMax)
        comm_graph_ = self.compute_communication_graph(pos, commRadius,
                                                       normalizeGraph)
        state = self.compute_states(pos, vel, comm_graph_)
        self._set_splits(init_pos, init_vel, pos, vel, accel, comm_graph_,
                         state)
        self.astype(dataType)

    def _init_env(self, nAgents, commRadius, repelDist, samplingTime,
                  initGeometry, initVelValue, initMinDist, accelMax,
                  normalizeGraph, doPrint, dataType, rng, device):
        Data.__init__(self)
        self.device = resolve_device(device)
        self.rng = np.random.default_rng() if rng is None else rng
        self.nAgents = nAgents
        self.commRadius = commRadius
        self.repelDist = repelDist
        self.nTrain = self.nValid = self.nTest = 0
        self.duration = 0.0
        self.samplingTime = samplingTime
        self.initGeometry = initGeometry
        self.initVelValue = initVelValue
        self.initMinDist = initMinDist
        self.accelMax = accelMax
        self.normalizeGraph = normalizeGraph
        self.doPrint = doPrint
        self.dataType = dataType
        # the closed-loop rollouts' defaults: the all-pairs env with dense
        # graphs and eigvalsh; rollout_ell_degree=D emits top-D ELL graphs,
        # rollout_lam_method='power' takes lambda_max by power iteration,
        # rollout_env_grid (with ell_degree) rolls on the cell grid
        self.rollout_ell_degree = None
        self.rollout_lam_method = "eig"
        self.rollout_env_chunk = None
        self.rollout_env_grid = None
        self.initPos, self.initVel = {}, {}
        self.pos, self.vel, self.accel = {}, {}, {}
        self.commGraph, self.state = {}, {}

    def _set_splits(self, init_pos, init_vel, pos, vel, accel, graphs,
                    state):
        """Split the generated arrays into train/valid/test; graphs a dense
        array or an EllGso with numpy leaves."""
        bounds = [0, self.nTrain, self.nTrain + self.nValid,
                  self.nTrain + self.nValid + self.nTest]
        for i, name in enumerate(("train", "valid", "test")):
            sl = slice(bounds[i], bounds[i + 1])
            self.samples[name]["signals"] = state[sl].copy()
            self.samples[name]["targets"] = accel[sl].copy()
            self.initPos[name] = init_pos[sl]
            self.initVel[name] = init_vel[sl]
            self.pos[name] = pos[sl]
            self.vel[name] = vel[sl]
            self.accel[name] = accel[sl]
            self.commGraph[name] = (
                EllGso(graphs.idx[sl].copy(), graphs.val[sl].copy())
                if isinstance(graphs, EllGso) else graphs[sl])
            self.state[name] = state[sl]

    @classmethod
    def for_rollout(cls, nAgents, commRadius, repelDist, samplingTime,
                    initGeometry="circular", initVelValue=3.0,
                    initMinDist=0.1, accelMax=10.0, normalizeGraph=True,
                    doPrint=False, dataType=np.float64, rng=None,
                    device="cuda"):
        """Environment-only construction: initial positions, the closed-loop
        rollouts and the cost, without expert trajectories."""
        self = cls.__new__(cls)
        self._init_env(nAgents, commRadius, repelDist, samplingTime,
                       initGeometry, initVelValue, initMinDist, accelMax,
                       normalizeGraph, doPrint, dataType, rng, device)
        return self

    @classmethod
    def large(cls, nAgents, commRadius, repelDist, nTrain, nValid, nTest,
              duration, samplingTime, ell_degree, env_chunk=None,
              lam_iters: int = 8, gen_batch: int = 4, rng=None,
              env_grid=None, device="cuda", **kw):
        """The large-swarm training set kept on the host (JAX
        ``Flocking.large``): the expert's supervision generated on
        ``device`` by :meth:`generate_trajectories_large`, gen_batch
        samples at a time, the graphs stored as an EllGso with numpy
        leaves (n, T, N, D), everything cast to f32. Without env_grid it is
        the chunked all-pairs env and expert (:func:`env_step_chunked`,
        :func:`expert_accel_chunked`; row chunk env_chunk, by default N //
        8, fitted to divide N), with env_grid the cell grid. The rollouts
        of TrainerFlocking and evaluate_flocking then run on the same env
        with ell_degree: ``rollout_env_chunk`` is set either way, as in
        JAX, and the grid, where given, takes precedence."""
        self = cls.for_rollout(nAgents, commRadius, repelDist, samplingTime,
                               rng=rng, device=device, **kw)
        self.duration = float(duration)
        self.nTrain, self.nValid, self.nTest = nTrain, nValid, nTest
        ell_degree = min(ell_degree, nAgents)
        env_chunk = _fit_chunk(nAgents, nAgents // 8 if env_chunk is None
                               else env_chunk)
        self.rollout_ell_degree = ell_degree
        self.rollout_lam_method = "power"
        self.rollout_env_chunk = env_chunk
        if env_grid is not None:
            self.rollout_env_grid = env_grid
        n_samples = nTrain + nValid + nTest
        init_pos, init_vel = self.compute_initial_positions(
            nAgents, n_samples, commRadius, minDist=self.initMinDist,
            geometry=self.initGeometry, xMaxInitVel=self.initVelValue,
            yMaxInitVel=self.initVelValue)
        outs = [self.generate_trajectories_large(
            init_pos[lo:lo + gen_batch], init_vel[lo:lo + gen_batch],
            duration, ell_degree, env_chunk, lam_iters=lam_iters,
            env_grid=env_grid) for lo in range(0, n_samples, gen_batch)]
        pos, vel, accel, state = (np.concatenate([o[i] for o in outs], 0)
                                  for i in range(4))
        graphs = EllGso(np.concatenate([o[4].idx for o in outs], 0),
                        np.concatenate([o[4].val for o in outs], 0))
        del outs
        self._set_splits(init_pos, init_vel, pos, vel, accel, graphs, state)
        self.astype(np.float32)
        return self

    @torch.no_grad()
    def generate_trajectories_large(self, init_pos, init_vel, duration,
                                    ell_degree: int, env_chunk,
                                    lam_iters: int = 8, env_grid=None):
        """The expert's supervision at large N on the device (JAX
        ``generate_trajectories_large``). Each step gives the states, the
        top-D ELL graph and the expert's acceleration (clip
        EXPERT_ACCEL_MAX), which drives the transition: without env_grid
        :func:`env_step_chunked` and :func:`expert_accel_chunked` in row
        chunks of env_chunk (which must divide N) at D = ell_degree; with
        env_grid one :func:`env_step_grid` with the expert's repel pass at
        D = min(ell_degree, N). The lambda eigenvector is carried across
        steps from the all-ones start at lam_iters passes a step.
        accel[T-1] is zeroed. Returns host numpy (pos, vel, accel, states
        (B,T,6,N), EllGso (idx (B,T,N,D), val (B,T,1,N,D))), f32, and with
        env_grid also the grid's exactness flag ok (a RuntimeWarning reports
        a cell overflow)."""
        use_grid = env_grid is not None
        if use_grid:
            gts, gcc, gcf = _parse_env_grid(env_grid)
        dt = self.samplingTime
        T = len(np.arange(0, duration, dt))
        p, u = self._as_device(init_pos), self._as_device(init_vel)
        B, _, N = p.shape
        D = min(int(ell_degree), N) if use_grid else int(ell_degree)
        pos, vel, accel = (p.new_empty((B, T, 2, N)) for _ in range(3))
        xs = p.new_empty((B, T, 6, N))
        gi = torch.empty((B, T, N, D), dtype=torch.int32, device=p.device)
        gv = p.new_empty((B, T, N, D))
        v = torch.ones((B, N), dtype=p.dtype, device=p.device) / math.sqrt(N)
        ok = torch.ones((), dtype=torch.bool, device=p.device)
        for t in range(T):
            if use_grid:
                gi[:, t], gv[:, t], xs[:, t], v, rep, ok_t = env_step_grid(
                    p, u, self.commRadius, D, v, lam_iters=lam_iters,
                    table_size=gts, cell_cap=gcc, cell_factor=gcf,
                    expert_repel=self.repelDist)
                a = _expert_from_repel(u, rep, EXPERT_ACCEL_MAX)
                ok = ok & ok_t
            else:
                gi[:, t], gv[:, t], xs[:, t], v = env_step_chunked(
                    p, u, self.commRadius, D, env_chunk, v,
                    lam_iters=lam_iters)
                a = expert_accel_chunked(p, u, self.repelDist,
                                         EXPERT_ACCEL_MAX, env_chunk)
            pos[:, t], vel[:, t], accel[:, t] = p, u, a
            p, u = a * dt * dt / 2 + u * dt + p, a * dt + u
        accel[:, T - 1] = 0.0
        host = lambda a: a.cpu().numpy()
        out = (host(pos), host(vel), host(accel), host(xs),
               EllGso(host(gi), host(gv)[:, :, None]))
        if not use_grid:
            return out
        ok = bool(ok)
        if not ok:
            warnings.warn("grid cell_cap overflowed during large-swarm "
                          "expert generation: neighbor sets (and expert "
                          "collision sums) may be incomplete; raise "
                          "cell_cap/table_size", RuntimeWarning)
        return out + (ok,)

    @classmethod
    def large_device(cls, nAgents, commRadius, repelDist, nTrain, nValid,
                     nTest, duration, samplingTime, ell_degree,
                     lam_iters: int = 1, gen_batch: int = 1, rng=None,
                     env_grid=True, device="cuda", **kw):
        """The device-resident training set (JAX ``Flocking.large_device``):
        the expert's trajectories generated on ``device`` by the grid env
        and the grid expert in eval shape (d_max = 0: no graph is emitted),
        and only (pos, vel) kept, (n, T, 2, N) f32 device tensors a split.
        ``TrainerFlocking(deviceStore=True, ellDegree=D)`` recomputes each
        batch's states, graphs and labels from them. ``lam_iters`` is the
        one lambda setting of generation, DAGger re-rolls, validation
        (``rollout_traj_device`` reads it) and the recompute. Samples are
        generated gen_batch at a time, the last chunk ragged (eager PyTorch
        needs no fixed shape, so it is not padded as the JAX generator's
        is); a RuntimeWarning reports a cell overflow."""
        self = cls.for_rollout(nAgents, commRadius, repelDist, samplingTime,
                               rng=rng, device=device, **kw)
        self.duration = float(duration)
        self.nTrain, self.nValid, self.nTest = nTrain, nValid, nTest
        self.rollout_ell_degree = min(ell_degree, nAgents)
        self.rollout_lam_method = "power"
        self.rollout_env_grid = env_grid
        self.rollout_lam_iters = lam_iters
        gts, gcc, gcf = _parse_env_grid(env_grid)
        n_samples = nTrain + nValid + nTest
        init_pos, init_vel = self.compute_initial_positions(
            nAgents, n_samples, commRadius, minDist=self.initMinDist,
            geometry=self.initGeometry, xMaxInitVel=self.initVelValue,
            yMaxInitVel=self.initVelValue)
        dt = samplingTime
        T = len(np.arange(0, duration, dt))

        def env(pos, vel, v, iters):
            *_, v, rep, ok = env_step_grid(
                pos, vel, commRadius, 0, v, lam_iters=iters,
                table_size=gts, cell_cap=gcc, cell_factor=gcf,
                expert_repel=repelDist)
            return _expert_from_repel(vel, rep, EXPERT_ACCEL_MAX), v, ok

        @torch.no_grad()
        def gen(pos0, vel0):
            B, _, N = pos0.shape
            pos = pos0.new_empty((B, T, 2, N))
            vel = pos0.new_empty((B, T, 2, N))
            pos[:, 0], vel[:, 0] = pos0, vel0
            v = torch.ones((B, N), dtype=pos0.dtype,
                           device=pos0.device) / math.sqrt(N)
            a, v, ok = env(pos0, vel0, v, max(lam_iters, 32))
            for t in range(1, T):
                p, u = pos[:, t - 1], vel[:, t - 1]
                vel[:, t] = a * dt + u
                pos[:, t] = a * dt * dt / 2 + u * dt + p
                a, v, ok_t = env(pos[:, t], vel[:, t], v, lam_iters)
                ok = ok & ok_t
            return pos, vel, ok

        pos_l, vel_l, oks = [], [], []
        for lo in range(0, n_samples, gen_batch):
            p, v, ok = gen(self._as_device(init_pos[lo:lo + gen_batch]),
                           self._as_device(init_vel[lo:lo + gen_batch]))
            pos_l.append(p)
            vel_l.append(v)
            oks.append(ok)
        pos = torch.cat(pos_l, 0)
        vel = torch.cat(vel_l, 0)
        del pos_l, vel_l
        self.generation_ok = bool(torch.stack(oks).all())
        if not self.generation_ok:
            warnings.warn("grid overflow during large_device expert "
                          "generation: raise cell_cap/table_size",
                          RuntimeWarning)
        bounds = [0, nTrain, nTrain + nValid, n_samples]
        for i, name in enumerate(("train", "valid", "test")):
            sl = slice(bounds[i], bounds[i + 1])
            self.initPos[name] = init_pos[sl]
            self.initVel[name] = init_vel[sl]
            self.pos[name] = pos[sl]           # device-resident
            self.vel[name] = vel[sl]
        return self

    def getData(self, name, samplesType, *args):
        """Auxiliary trajectories: 'pos'|'vel'|'accel'|'commGraph'|'state'|
        'initPos'|'initVel' of a split (reference dataTools.py:3021-3080);
        an int argument draws that many samples at random (numpy's global
        generator, as the JAX package does), an index array selects."""
        store = {"pos": self.pos, "vel": self.vel, "accel": self.accel,
                 "commGraph": self.commGraph, "state": self.state,
                 "initPos": self.initPos, "initVel": self.initVel}[name]
        out = store[samplesType]
        if len(args) == 1:
            if isinstance(args[0], int):
                idx = np.random.permutation(out.shape[0])[:args[0]]
            else:
                idx = np.asarray(args[0])
            out = out[idx]
        return out

    get_data = getData

    def comm_graph_ell(self, samplesType, d_max=None) -> EllGso:
        """A split's stored communication-graph trajectories as an
        ``ops.ell.EllGso`` (the O(N·deg) padded in-neighbour layout,
        ``ell_from_dense`` of the dense (B, T, N, N) stack, on the CPU),
        which every DB architecture takes in place of the dense stack. A
        store that already holds ELL graphs (``Flocking.large``) returns
        them as they are."""
        S = self.getData("commGraph", samplesType)
        if isinstance(S, EllGso):
            if d_max is not None and d_max != S.idx.shape[-1]:
                raise ValueError(f"the store's ELL graphs have width "
                                 f"{S.idx.shape[-1]}, not {d_max}")
            return S
        return ell_from_dense(np.asarray(S)[:, :, None], d_max=d_max)

    # -- initial conditions (reference dataTools.py:3508-3700) --------------
    def compute_initial_positions(self, nAgents, nSamples, commRadius,
                                  minDist=0.1, geometry="rectangular",
                                  xMaxInitVel=3.0, yMaxInitVel=3.0):
        """Grid/circle initial placement with perturbations (numpy, from
        self.rng: the JAX package's arrays for the same generator)."""
        rng = self.rng
        if geometry not in ("rectangular", "circular"):
            raise ValueError(f"unknown geometry {geometry!r}")
        min_dist = minDist * (1 + ZERO_TOL)
        comm_radius = commRadius * (1 - ZERO_TOL)
        if geometry == "rectangular":
            dist_fixed = (comm_radius + min_dist) / (2.0 * np.sqrt(2))
            dist_perturb = (comm_radius - min_dist) / (4.0 * np.sqrt(2))
            per_axis = int(np.ceil(np.sqrt(nAgents)))
            axis = np.arange(-(per_axis * dist_fixed) / 2,
                             (per_axis * dist_fixed) / 2, step=dist_fixed)
            xf = np.tile(axis, per_axis)
            yf = np.repeat(axis, per_axis)
            fixed = np.stack([xf, yf])[:, :nAgents]
            fixed = np.repeat(fixed[None], nSamples, axis=0)
            perturb = rng.uniform(-dist_perturb, dist_perturb,
                                  (nSamples, 2, nAgents))
            init_pos = fixed + perturb
        else:
            r_fixed = (comm_radius + min_dist) / 2.0
            r_perturb = (comm_radius - min_dist) / 4.0
            fixed_radius = (np.arange(0, r_fixed * nAgents, step=r_fixed)
                            + r_fixed)
            a_fixed = (comm_radius / fixed_radius
                       + min_dist / fixed_radius) / 2.0
            for a in range(len(a_fixed)):
                per_circle = 2 * np.pi // a_fixed[a]
                a_fixed[a] = 2 * np.pi / per_circle
            init_radius = np.empty(0)
            init_angles = np.empty(0)
            agents_so_far, n = 0, 0
            while agents_so_far < nAgents:
                this_angles = np.arange(0, 2 * np.pi, step=a_fixed[n])
                agents_so_far += len(this_angles)
                init_radius = np.concatenate(
                    [init_radius, np.repeat(fixed_radius[n],
                                            len(this_angles))])
                init_angles = np.concatenate([init_angles, this_angles])
                n += 1
            init_radius = init_radius[:nAgents]
            init_angles = init_angles[:nAgents]
            init_radius = np.repeat(init_radius[None], nSamples, 0)
            init_angles = np.repeat(init_angles[None], nSamples, 0)
            init_radius += rng.uniform(-r_perturb, r_perturb,
                                       (nSamples, nAgents))
            per_angle_perturb = min(a_fixed) / 4
            init_angles += rng.uniform(-per_angle_perturb, per_angle_perturb,
                                       (nSamples, nAgents))
            init_pos = np.stack([init_radius * np.cos(init_angles),
                                 init_radius * np.sin(init_angles)], axis=1)
        # velocities: uniform per-sample bias + small per-agent perturbation
        x_vel = rng.uniform(-xMaxInitVel, xMaxInitVel, (nSamples, 1))
        y_vel = rng.uniform(-yMaxInitVel, yMaxInitVel, (nSamples, 1))
        vel_bias = np.stack([x_vel, y_vel], axis=1)   # nSamples x 2 x 1
        perturb = rng.uniform(-xMaxInitVel / 10, xMaxInitVel / 10,
                              (nSamples, 2, nAgents))
        init_vel = vel_bias + perturb
        return init_pos, init_vel

    # -- the expert (reference dataTools.py:3406-3506) ----------------------
    def compute_optimal_trajectory(self, initPos, initVel, duration,
                                   samplingTime, repelDist, accelMax=100.0):
        """The centralized expert's trajectories from (S, 2, N) initial
        conditions, f64 numpy: (pos, vel, accel) each (S, T, 2, N). The
        acceleration is the velocity consensus plus the collision-avoidance
        sum over the pairs closer than repelDist, clipped at accelMax;
        accel[:, T-1] stays zero (it drives no transition in the
        horizon)."""
        nSamples, _, nAgents = initPos.shape
        T = len(np.arange(0, duration, samplingTime))
        pos = np.zeros((nSamples, T, 2, nAgents))
        vel = np.zeros((nSamples, T, 2, nAgents))
        accel = np.zeros((nSamples, T, 2, nAgents))
        pos[:, 0] = initPos
        vel[:, 0] = initVel
        for t in range(1, T):
            accel[:, t - 1] = expert_accel_host(pos[:, t - 1], vel[:, t - 1],
                                                repelDist, accelMax)
            vel[:, t] = accel[:, t - 1] * samplingTime + vel[:, t - 1]
            pos[:, t] = (accel[:, t - 1] * samplingTime ** 2 / 2
                         + vel[:, t - 1] * samplingTime + pos[:, t - 1])
        return pos, vel, accel

    # -- communication graph (reference dataTools.py:2816-3020) -------------
    def compute_communication_graph(self, pos, commRadius, normalizeGraph,
                                    kernelType="gaussian", weighted=False,
                                    kernelScale=1.0):
        """Host f64 graphs of (S, [T,] 2, N) positions -> (S, [T,] N, N):
        the gaussian kernel cut at commRadius, no self loops, unweighted
        unless ``weighted``, divided by lambda_max (eigvalsh) when
        normalizeGraph."""
        squeeze = pos.ndim == 3
        if squeeze:
            pos = pos[:, None]
        N = pos.shape[-1]
        _, dist_sq = compute_differences(pos)
        if kernelType == "gaussian":
            W = np.exp(-kernelScale * dist_sq)
        else:
            W = dist_sq.copy()
        W[dist_sq > commRadius ** 2] = 0.0
        idx = np.arange(N)
        W[:, :, idx, idx] = 0.0
        if not weighted:
            W = (W > ZERO_TOL).astype(np.float64)
        if normalizeGraph:
            lam = np.max(np.linalg.eigvalsh(W), axis=-1)
            lam[np.abs(lam) < ZERO_TOL] = 1.0
            W = W / lam[..., None, None]
        return W[:, 0] if squeeze else W

    # -- states (reference dataTools.py:2612-2815) --------------------------
    def compute_states(self, pos, vel, graphMatrix):
        """Host f64 6-feature agent states (S, [T,] 6, N) on the graph's
        support: the summed velocity differences and the position
        differences weighted by 1/d^4 and 1/d^2."""
        diff_pos, dist_sq = compute_differences(pos)
        diff_vel, _ = compute_differences(vel)
        adj = (np.abs(graphMatrix) > ZERO_TOL).astype(
            np.float64)[..., None, :, :]
        dist_sq_inv = invert_tensor_ew(dist_sq)[..., None, :, :] * adj
        diff_pos = diff_pos * adj
        diff_vel = diff_vel * adj
        state_vel = np.sum(diff_vel, axis=-1)
        state_pos_fourth = np.sum(diff_pos * dist_sq_inv ** 2, axis=-1)
        state_pos_sq = np.sum(diff_pos * dist_sq_inv, axis=-1)
        return np.concatenate([state_vel, state_pos_fourth, state_pos_sq],
                              axis=-2)

    # -- closed-loop rollout (reference dataTools.py:3166-3340) -------------
    def _chunked_pieces(self, policy, ell_degree, lam_iters, env_grid,
                        return_graphs=True, env_chunk=None, w=None):
        """init/step closures of the O(N·deg) rollout (JAX
        ``_chunked_pieces``): on the cell grid when env_grid is set, else
        on the chunked all-pairs env (:func:`env_step_chunked`, row chunks
        of env_chunk fitted to divide N; its ok stays True). The carry ends
        with the lambda eigenvector and ok.

        Step mode (w None), fused on the grid only, when the policy has the
        payload interface, one edge feature and 0 < payload_width <= 1.5 *
        ell_degree: its registers ride the grid env's cell table as payload
        feature blocks and the env's own window pass returns their graph
        shift, so a step shifts no register over the emitted graph. carry =
        (pos, vel, x_t, shifted registers, policy state, v, ok).

        Step mode unfused, any other policy with ``rollout_step`` (a GRNN's
        wide registers, E > 1, or any policy on the chunked env): each step
        the policy shifts its registers over the step's emitted ELL graph
        (``EllGso.db_shift_rows``), then the physics, then the env step
        emits the next graph. carry = (pos, vel, x_t, idx_t, val_t, policy
        state, v, ok); on the grid ok also flags an in-degree above the
        emitted width, since the policy shifts over that truncation.

        Windowed (w an int; JAX's step_mode=False): each step the policy's
        full-history forward ``policy(x_hist (B,w,6,N), EllGso(idx (B,w,N,
        D), val (B,w,1,N,D)))`` over the last w steps, whose last tap drives
        the physics. The history starts zero-padded: step 0 in the last
        slot, zero states and the all-zero graph (idx 0, val 0) before it,
        which a causal policy ignores. carry = (pos, vel, x window, idx
        window, val window, v, ok).

        return_graphs: True emits the first-d_max ELL graph of every step
        (d_max = min(ell_degree, N)); False emits zero columns and skips
        the selection, which only the fused rollout can do (its shifts sum
        the untruncated neighbor mask, so positions are the same either
        way); "auto" is False exactly when the rollout is fused.
        """
        dt = self.samplingTime
        r = self.commRadius
        a_max = self.accelMax
        use_grid = env_grid is not None
        if use_grid:
            gts, gcc, gcf = _parse_env_grid(env_grid)
        pw = getattr(policy, "payload_width", 0)
        fused = (w is None and use_grid
                 and hasattr(policy, "rollout_step_shifted")
                 and hasattr(policy, "rollout_payload")
                 and getattr(policy, "E", None) == 1
                 and 0 < pw <= 1.5 * ell_degree)
        if return_graphs == "auto":
            return_graphs = not fused
        if not (return_graphs or fused):
            raise ValueError(
                "return_graphs=False requires the fused-policy grid rollout: "
                f"{type(policy).__name__} (payload width {pw}, ell_degree "
                f"{ell_degree}) shifts its registers over the emitted ELL "
                "graph each step")

        def env_step(pos, vel, v, iters, payload=None):
            N = pos.shape[-1]
            D = min(ell_degree, N) if return_graphs else 0
            if not use_grid:
                out = env_step_chunked(pos, vel, r, D,
                                       _fit_chunk(N, env_chunk), v,
                                       lam_iters=iters)
                return (*out, torch.ones((), dtype=torch.bool,
                                         device=pos.device))
            out = env_step_grid(pos, vel, r, D, v, lam_iters=iters,
                                table_size=gts, cell_cap=gcc,
                                cell_factor=gcf, payload=payload,
                                in_degree=not fused)
            if fused:
                return out
            *out, deg, ok = out
            return (*out, ok & (deg.amax() <= D))

        def init_fn(init_pos, init_vel):
            B, _, N = init_pos.shape
            v0 = torch.ones((B, N), dtype=init_pos.dtype,
                            device=init_pos.device) / math.sqrt(N)
            # cold start: converge the eigenvector
            i0, s0, x0, v0, ok = env_step(init_pos, init_vel, v0,
                                          max(lam_iters, 32))
            if w is not None:
                xw, iw, vw = _windows((x0, i0, s0[:, None]), w)
                return ((init_pos, init_vel, xw, iw, vw, v0, ok),
                        (x0, (i0, s0)))
            pstate = policy.rollout_init(B, N)
            if not fused:
                return ((init_pos, init_vel, x0, i0, s0, pstate, v0, ok),
                        (x0, (i0, s0)))
            # zero registers shift to zero: no payload pass needed
            sh0 = torch.zeros_like(policy.rollout_payload(pstate)
                                   .reshape(B, N, -1))
            return ((init_pos, init_vel, x0, sh0, pstate, v0, ok),
                    (x0, (i0, s0)))

        def physics(pos_t, vel_t, y):
            a = torch.clamp(y, -a_max, a_max)
            return a, a * dt * dt / 2 + vel_t * dt + pos_t, a * dt + vel_t

        def step_fused(carry):
            pos_t, vel_t, x_t, sh_t, pstate, v, ok = carry
            B, _, N = pos_t.shape
            pstate, y = policy.rollout_step_shifted(pstate, x_t, sh_t)
            a, pos_n, vel_n = physics(pos_t, vel_t, y)
            pay = policy.rollout_payload(pstate).reshape(B, N, -1)
            i_n, s_n, x_n, v, sh_n, ok_n = env_step(pos_n, vel_n, v,
                                                    lam_iters, payload=pay)
            return ((pos_n, vel_n, x_n, sh_n, pstate, v, ok & ok_n),
                    (pos_n, vel_n, a, x_n, (i_n, s_n)))

        def step_unfused(carry):
            pos_t, vel_t, x_t, i_t, s_t, pstate, v, ok = carry
            pstate, y = policy.rollout_step(pstate, x_t,
                                            EllGso(i_t, s_t[:, None]))
            a, pos_n, vel_n = physics(pos_t, vel_t, y)
            i_n, s_n, x_n, v, ok_n = env_step(pos_n, vel_n, v, lam_iters)
            return ((pos_n, vel_n, x_n, i_n, s_n, pstate, v, ok & ok_n),
                    (pos_n, vel_n, a, x_n, (i_n, s_n)))

        def step_windowed(carry):
            pos_t, vel_t, xw, iw, vw, v, ok = carry
            y = policy(xw, EllGso(iw, vw))
            a, pos_n, vel_n = physics(pos_t, vel_t, y[:, -1])
            i_n, s_n, x_n, v, ok_n = env_step(pos_n, vel_n, v, lam_iters)
            xw, iw, vw = _roll_windows((xw, iw, vw),
                                       (x_n, i_n, s_n[:, None]))
            return ((pos_n, vel_n, xw, iw, vw, v, ok & ok_n),
                    (pos_n, vel_n, a, x_n, (i_n, s_n)))

        if w is not None:
            return init_fn, step_windowed
        return init_fn, step_fused if fused else step_unfused

    def _dense_pieces(self, policy, ell_degree, lam_method, w=None):
        """init/step closures of the all-pairs closed loop (JAX
        ``_scan_rollout``'s non-chunked branch): each step the policy acts
        on the step's graph, then the physics, then the dense graph of the
        new positions (:func:`comm_graph`, lambda_max by ``lam_method``:
        'eig' or 'power') and its states. The graph is the dense (B,N,N)
        one, or with ell_degree its top-D ELL form (:func:`ell_topk`), as
        in JAX. Step mode (w None): one ``rollout_step``; carry = (pos, vel,
        x_t, graph_t, policy state, ok). Windowed (w an int): the policy's
        full-history forward over the last w steps' states and graphs,
        zero-padded at the start as in :meth:`_chunked_pieces`, its last
        tap driving the physics; carry = (pos, vel, x window, graph window
        (dense (B,w,N,N), or ELL idx (B,w,N,D) and val (B,w,1,N,D)), ok).
        ok stays True. The two modes agree up to float association."""
        dt = self.samplingTime
        r = self.commRadius
        a_max = self.accelMax

        def env(pos, vel):
            """(states, what the policy takes, the graph the step emits,
            the graph's window entries)."""
            S = comm_graph(pos, r, lam_method)
            x = states(pos, vel, S)
            if ell_degree is None:
                return x, S, S, (S,)
            e = ell_topk(S[:, None], min(ell_degree, pos.shape[-1]))
            return x, e, (e.idx, e.val[:, 0]), (e.idx, e.val)

        def hist(parts):
            return parts[0] if ell_degree is None else EllGso(*parts)

        def init_fn(init_pos, init_vel):
            B, _, N = init_pos.shape
            x0, g0, out0, parts = env(init_pos, init_vel)
            ok = torch.ones((), dtype=torch.bool, device=init_pos.device)
            if w is not None:
                xw, *gw = _windows((x0,) + parts, w)
                return (init_pos, init_vel, xw, tuple(gw), ok), (x0, out0)
            return ((init_pos, init_vel, x0, g0, policy.rollout_init(B, N),
                     ok), (x0, out0))

        def advance(pos_t, vel_t, y):
            a = torch.clamp(y, -a_max, a_max)
            vel_n = a * dt + vel_t
            pos_n = a * dt * dt / 2 + vel_t * dt + pos_t
            return a, pos_n, vel_n

        def step_fn(carry):
            pos_t, vel_t, x_t, g_t, pstate, ok = carry
            pstate, y = policy.rollout_step(pstate, x_t, g_t)
            a, pos_n, vel_n = advance(pos_t, vel_t, y)
            x_n, g_n, out_n, _ = env(pos_n, vel_n)
            return ((pos_n, vel_n, x_n, g_n, pstate, ok),
                    (pos_n, vel_n, a, x_n, out_n))

        def step_windowed(carry):
            pos_t, vel_t, xw, gw, ok = carry
            y = policy(xw, hist(gw))
            a, pos_n, vel_n = advance(pos_t, vel_t, y[:, -1])
            x_n, _, out_n, parts = env(pos_n, vel_n)
            xw, *gw = _roll_windows((xw,) + gw, (x_n,) + parts)
            return ((pos_n, vel_n, xw, tuple(gw), ok),
                    (pos_n, vel_n, a, x_n, out_n))

        return init_fn, step_fn if w is None else step_windowed

    def _pieces(self, policy, ell_degree, env_grid, lam_iters, lam_method,
                return_graphs=True, env_chunk=None, w=None):
        """The rollout's init/step closures: the O(N·deg) loop on the grid
        or the chunked all-pairs env when env_grid or env_chunk is set,
        else the all-pairs loop; step mode, or the windowed re-forward over
        w steps. A step emits (pos, vel, accel, states, graph), the graph a
        dense (B,N,N) tensor or an ELL (idx, val) pair."""
        if env_grid is not None or env_chunk is not None:
            return self._chunked_pieces(policy, ell_degree, lam_iters,
                                        env_grid, return_graphs,
                                        env_chunk=env_chunk, w=w)
        return self._dense_pieces(policy, ell_degree, lam_method, w=w)

    def _rollout_args(self, archit, ell_degree, env_grid, step_mode,
                      lam_method="eig", env_chunk=None, history_window=None):
        """(ell_degree, env_grid, env_chunk, lam_method, w) with the
        dataset's rollout defaults, as JAX resolves them. w is None in step
        mode (step_mode None or True and a policy with ``rollout_step``),
        else the windowed re-forward's history_window, which it needs."""
        if (step_mode is None or step_mode) and hasattr(archit,
                                                         "rollout_step"):
            w = None
        elif history_window is None:
            raise ValueError(
                f"{type(archit).__name__} rolls out through the windowed "
                "re-forward (step_mode=False, or no step interface "
                "rollout_init/rollout_step), which needs history_window")
        else:
            w = int(history_window)
        if ell_degree is None:
            ell_degree = self.rollout_ell_degree
        if env_grid is None:
            env_grid = self.rollout_env_grid
        if env_chunk is None:
            env_chunk = self.rollout_env_chunk
        if env_grid is not None and ell_degree is None:
            raise ValueError("env_grid requires ell_degree (the O(N*deg) "
                             "graph layout)")
        if env_chunk is not None and ell_degree is None:
            raise ValueError("env_chunk requires ell_degree (the O(N*deg) "
                             "graph layout)")
        if lam_method == "eig" and self.rollout_lam_method != "eig":
            lam_method = self.rollout_lam_method
        return ell_degree, env_grid, env_chunk, lam_method, w

    def _as_device(self, a) -> torch.Tensor:
        """Host array -> the rollout's f32 device tensor (through f64, as
        the JAX package converts its inputs)."""
        return torch.as_tensor(np.asarray(a, np.float64),
                               device=self.device).to(torch.float32)

    @torch.no_grad()
    def _rollout(self, init_pos, init_vel, T, pieces, traj_only=False):
        """The closed loop over T steps of ``pieces`` (init/step closures),
        on device tensors: (pos, vel[, accel, states, graphs], ok), each
        (B, T, ...); accel from step t drives the transition into t+1 and
        is stored at t. graphs: a dense (B,T,N,N) tensor or an EllGso (idx
        (B,T,N,D), val (B,T,1,N,D))."""
        init_fn, step_fn = pieces
        carry, (x0, g0) = init_fn(init_pos, init_vel)
        B, _, N = init_pos.shape
        pos = init_pos.new_empty((B, T, 2, N))
        vel = init_pos.new_empty((B, T, 2, N))
        pos[:, 0], vel[:, 0] = init_pos, init_vel
        parts = lambda g: g if isinstance(g, tuple) else (g,)
        if not traj_only:
            accel = init_pos.new_zeros((B, T, 2, N))
            xs = init_pos.new_empty((B, T, 6, N))
            gs = [a.new_empty((B, T) + tuple(a.shape[1:])) for a in parts(g0)]
            xs[:, 0] = x0
            for buf, part in zip(gs, parts(g0)):
                buf[:, 0] = part
        for t in range(1, T):
            carry, (p, v, a, x, g) = step_fn(carry)
            pos[:, t], vel[:, t] = p, v
            if not traj_only:
                accel[:, t - 1], xs[:, t] = a, x
                for buf, part in zip(gs, parts(g)):
                    buf[:, t] = part
        ok = carry[-1]
        if traj_only:
            return pos, vel, ok
        graphs = EllGso(gs[0], gs[1][:, :, None]) if len(gs) == 2 else gs[0]
        return pos, vel, accel, xs, graphs, ok

    @torch.no_grad()
    def _rollout_segmented(self, init_pos, init_vel, T, pieces, seg: int):
        """The same closed loop in host segments (JAX
        ``_scan_rollout_segmented``): the carry stays on the device, and
        after each run of at most seg steps that segment's (pos, vel,
        accel, states, ELL graphs) are pulled to the host, so the device
        holds O(seg·N·D) of trajectory, not O(T·N·D). The same closures as
        :meth:`_rollout`, so the same numbers. Returns host numpy (pos,
        vel, accel, states, EllGso) and ok; T = 1 gives the init-only
        trajectory."""
        init_fn, step_fn = pieces
        carry, (x0, (i0, s0)) = init_fn(init_pos, init_vel)
        host = lambda t: t.cpu().numpy()
        cols = [[host(a)[:, None]] for a in (init_pos, init_vel, x0, i0, s0)]
        acc = []
        left = T - 1
        while left > 0:
            n = min(seg, left)
            outs = []
            for _ in range(n):
                carry, (p, v, a, x, (i, s)) = step_fn(carry)
                outs.append((p, v, x, i, s, a))
            for k in range(6):
                got = host(torch.stack([o[k] for o in outs], dim=1))
                (acc if k == 5 else cols[k]).append(got)
            left -= n
        pos, vel, xs, gi, gv = (np.concatenate(c, axis=1) for c in cols)
        acc.append(np.zeros_like(pos[:, :1]))
        graphs = EllGso(gi, gv[:, :, None])
        return (pos, vel, np.concatenate(acc, axis=1), xs, graphs), carry[-1]

    def _open_loop(self, initPos, initVel, accel, T):
        """Replay a given acceleration sequence (B,T,2,N), host f64 (JAX
        ``compute_trajectory(accel=...)``): (pos, vel, accel, None,
        None)."""
        dt = self.samplingTime
        accel = np.asarray(accel, np.float64)
        B, _, N = np.shape(initPos)
        pos = np.zeros((B, T, 2, N))
        vel = np.zeros((B, T, 2, N))
        pos[:, 0], vel[:, 0] = initPos, initVel
        for t in range(1, T):
            vel[:, t] = accel[:, t - 1] * dt + vel[:, t - 1]
            pos[:, t] = (accel[:, t - 1] * dt ** 2 / 2 + vel[:, t - 1] * dt
                         + pos[:, t - 1])
        return pos, vel, accel, None, None

    @torch.no_grad()
    def _host_loop(self, initPos, initVel, T, archit, history_window):
        """The host closed loop (JAX ``compute_trajectory``'s loop for a
        policy without params): host f64 dense graphs
        (``compute_communication_graph``, eigvalsh) and states each step;
        the policy ``archit(x_hist, S_hist) -> (B, w, 2, N)`` sees the
        full zero-padded horizon (its output at t-1 drives the physics) or,
        with history_window, the last w steps left-padded with zeros (its
        last tap drives it), handed over as f32 tensors on the dataset's
        device. Returns host f64 (pos, vel, accel, states, dense graphs)."""
        dt = self.samplingTime
        initPos = np.asarray(initPos, np.float64)
        B, _, N = initPos.shape
        pos = np.zeros((B, T, 2, N))
        vel = np.zeros((B, T, 2, N))
        pos[:, 0], vel[:, 0] = initPos, initVel
        accel = np.zeros((B, T, 2, N))
        xs = np.zeros((B, T, 6, N))
        gs = np.zeros((B, T, N, N))

        def observe(t):
            gs[:, t] = self.compute_communication_graph(
                pos[:, t], self.commRadius, True)
            xs[:, t] = self.compute_states(pos[:, t:t + 1], vel[:, t:t + 1],
                                           gs[:, t:t + 1])[:, 0]

        as_t = lambda a: torch.as_tensor(a, dtype=torch.float32,
                                         device=self.device)
        observe(0)
        for t in range(1, T):
            if history_window is None:
                y = archit(as_t(xs), as_t(gs))[:, t - 1]
            else:
                lo = max(t - int(history_window), 0)
                pad = int(history_window) - (t - lo)
                padded = lambda a: np.concatenate(
                    [np.zeros((B, pad) + a.shape[2:]), a[:, lo:t]], axis=1)
                y = archit(as_t(padded(xs)), as_t(padded(gs)))[:, -1]
            y = np.asarray(torch.as_tensor(y).cpu(), np.float64)
            accel[:, t - 1] = np.clip(y, -self.accelMax, self.accelMax)
            vel[:, t] = accel[:, t - 1] * dt + vel[:, t - 1]
            pos[:, t] = (accel[:, t - 1] * dt ** 2 / 2 + vel[:, t - 1] * dt
                         + pos[:, t - 1])
            observe(t)
        return pos, vel, accel, xs, gs

    def compute_trajectory(self, initPos, initVel, duration, archit=None,
                           accel=None, params=None, rng=None, doPrint=None,
                           history_window=None, jit=True, ell_degree=None,
                           lam_method: str = "eig", env_chunk=None,
                           lam_iters: int = 8, seg=None, step_mode=None,
                           env_grid=None, env_grid_strict: bool = False,
                           return_graphs=True):
        """Roll the swarm forward (JAX ``compute_trajectory``); returns host
        float64 (pos, vel, accel, states) of shape (B, T, ., N) and the
        graph trajectory: the dense (B,T,N,N) stack (f64), or an EllGso
        (idx int32 (B,T,N,D), val f64 (B,T,1,N,D)).

        ``accel`` (B,T,2,N): the open loop, replaying it (states and graphs
        None). Else ``archit`` closes the loop. An ``nn.Module`` with the
        step interface (step_mode None or True) runs it on the device, one
        ``rollout_step`` a step; with step_mode=False, or without that
        interface, a module runs the windowed re-forward over the last
        ``history_window`` steps on the device. Every other case (a plain
        callable, jit=False, or no history_window for a module without the
        step interface) takes the host loop over the full horizon or the
        window (:meth:`_host_loop`). Parameters live in the module: params,
        rng and doPrint are taken for the JAX signature and not used.

        The device loop's env: env_grid, env_chunk, ell_degree and
        lam_method default to the dataset's rollout_env_grid /
        rollout_env_chunk / rollout_ell_degree / rollout_lam_method.
        With env_grid (True, (table_size, cell_cap) or a 3-tuple with the
        cell factor) it is the cell grid: a RuntimeWarning (a RuntimeError
        when env_grid_strict) reports a cell overflow or an in-degree above
        ell_degree; return_graphs False / "auto": zero ELL columns, the
        same positions (the fused rollout only). Else with env_chunk the
        chunked all-pairs env (:func:`env_step_chunked`), else the
        all-pairs env (dense graphs, or top-D ELL ones with ell_degree;
        lambda_max by eigvalsh or, 'power', power iteration). lam_iters:
        warm-started power iterations a step on the grid and the chunked
        env (0 on the grid: the zero-pass Rayleigh fold). seg: the grid or
        chunked rollout in host segments of at most seg steps
        (:meth:`_rollout_segmented`), the same numbers."""
        if archit is None and accel is None:
            raise ValueError("compute_trajectory needs archit or accel")
        T = len(np.arange(0, duration, self.samplingTime))
        if accel is not None:
            return self._open_loop(initPos, initVel, accel, T)
        step = ((step_mode is None or step_mode)
                and hasattr(archit, "rollout_step"))
        if not (jit and isinstance(archit, torch.nn.Module)
                and (step or history_window is not None)):
            return self._host_loop(initPos, initVel, T, archit,
                                   history_window)
        ell_degree, env_grid, env_chunk, lam_method, w = self._rollout_args(
            archit, ell_degree, env_grid, step_mode, lam_method, env_chunk,
            history_window)
        init_pos, init_vel = self._as_device(initPos), self._as_device(initVel)
        if seg is not None:
            if env_grid is None and env_chunk is None:
                raise ValueError("seg= requires env_chunk or env_grid (the "
                                 "O(N*deg) env is what the segmented rollout "
                                 "segments)")
            if not return_graphs:
                raise ValueError("return_graphs=False is monolithic only "
                                 "(each segment's host pull includes its "
                                 "graphs)")
            pieces = self._pieces(archit, ell_degree, env_grid, lam_iters,
                                  lam_method, env_chunk=env_chunk, w=w)
            out, ok = self._rollout_segmented(init_pos, init_vel, T, pieces,
                                              int(seg))
            _grid_warning(ok, env_grid_strict)
            pos, vel, acc, xs, g = out
            return (pos.astype(np.float64), vel.astype(np.float64),
                    acc.astype(np.float64), xs.astype(np.float64),
                    EllGso(g.idx, g.val.astype(np.float64)))
        pieces = self._pieces(archit, ell_degree, env_grid, lam_iters,
                              lam_method, return_graphs, env_chunk, w)
        *out, ok = self._rollout(init_pos, init_vel, T, pieces)
        _grid_warning(ok, env_grid_strict)
        host = lambda t: t.cpu().numpy()
        pos, vel, accel, xs, g = out
        g = (EllGso(host(g.idx), host(g.val).astype(np.float64))
             if isinstance(g, EllGso) else host(g).astype(np.float64))
        return (host(pos).astype(np.float64), host(vel).astype(np.float64),
                host(accel).astype(np.float64), host(xs).astype(np.float64),
                g)

    computeTrajectory = compute_trajectory

    def rollout_traj_device(self, initPos, initVel, duration, archit,
                            params=None, history_window=None,
                            ell_degree=None, lam_method: str = "eig",
                            env_chunk=None, lam_iters=None, step_mode=None,
                            env_grid=None, env_grid_strict: bool = False):
        """The closed-loop rollout's DEVICE (pos, vel), (B,T,2,N) float32:
        nothing else is stacked, and the exactness flag is the one scalar
        read. The same step closures as compute_trajectory's device loop
        (step mode, or the windowed re-forward over history_window).
        lam_iters defaults to the dataset's ``rollout_lam_iters`` (set by
        ``large_device``, so DAGger re-rolls normalize their graphs as
        generation and the recompute do), else 8; params is taken for the
        JAX signature."""
        ell_degree, env_grid, env_chunk, lam_method, w = self._rollout_args(
            archit, ell_degree, env_grid, step_mode, lam_method, env_chunk,
            history_window)
        if lam_iters is None:
            lam_iters = getattr(self, "rollout_lam_iters", 8)
        T = len(np.arange(0, duration, self.samplingTime))
        pieces = self._pieces(archit, ell_degree, env_grid, lam_iters,
                              lam_method, "auto", env_chunk, w)
        pos, vel, ok = self._rollout(
            self._as_device(initPos), self._as_device(initVel), T, pieces,
            traj_only=True)
        _grid_warning(ok, env_grid_strict)
        return pos, vel

    # -- cost (reference dataTools.py:3082-3164) ----------------------------
    @torch.no_grad()
    def rollout_cost(self, initPos, initVel, duration, archit, params=None,
                     history_window=None, ell_degree=None, env_chunk=None,
                     env_grid=None, lam_iters: int = 8, step_mode=None,
                     env_grid_strict: bool = False):
        """The closed-loop rollout reduced to the flocking cost on the
        device: (cost_full, cost_end), ``evaluate``'s velocity-variance
        cost over the whole trajectory and at the final step, accumulated
        step by step; no trajectory is kept (two scalars and the exactness
        flag read at the end). The dataset's environment, as
        compute_trajectory's; the windowed re-forward's window defaults to
        the policy's causal_window (JAX); params is taken for the JAX
        signature."""
        if history_window is None:
            history_window = getattr(archit, "causal_window", None) or None
        ell_degree, env_grid, env_chunk, lam_method, w = self._rollout_args(
            archit, ell_degree, env_grid, step_mode, "eig", env_chunk,
            history_window)
        T = len(np.arange(0, duration, self.samplingTime))
        init_fn, step_fn = self._pieces(archit, ell_degree, env_grid,
                                        lam_iters, lam_method, "auto",
                                        env_chunk, w)

        def stepcost(vel):                        # (B,2,N) -> (B,)
            d = vel - vel.mean(dim=-1, keepdim=True)
            return (d * d).sum(1).mean(-1)

        init_pos, init_vel = self._as_device(initPos), self._as_device(initVel)
        carry, _ = init_fn(init_pos, init_vel)
        acc = last = stepcost(init_vel)
        for _ in range(T - 1):
            carry, ys = step_fn(carry)
            last = stepcost(ys[1])                # vel_n
            acc = acc + last
        _grid_warning(carry[-1], env_grid_strict)
        return float(acc.mean()), float(last.mean())

    def evaluate(self, vel=None, accel=None, initVel=None,
                 samplingTime=None):
        """Velocity-variance flocking cost: sum over time of the mean
        squared deviation from the swarm-average velocity, averaged over
        samples (numpy, on the host)."""
        if samplingTime is None:
            samplingTime = self.samplingTime
        if vel is None:
            if accel is None or initVel is None:
                raise ValueError("evaluate needs vel, or accel and initVel")
            B, T, _, N = accel.shape
            vel = np.zeros((B, T, 2, N))
            vel[:, 0] = initVel
            for t in range(1, T):
                vel[:, t] = accel[:, t - 1] * samplingTime + vel[:, t - 1]
        avg_vel = vel.mean(axis=3, keepdims=True)
        diff = vel - avg_vel
        cost_t = np.mean(np.sum(diff ** 2, axis=2), axis=2)  # B x T
        return float(np.mean(np.sum(cost_t, axis=1)))

    def astype(self, dataType):
        """Cast the host stores and the samples to dataType (an EllGso's
        val; its idx stays integer)."""
        for key in ("train", "valid", "test"):
            for store in (self.initPos, self.initVel, self.pos, self.vel,
                          self.accel, self.commGraph, self.state):
                if key not in store:
                    continue              # env-only construction
                v = store[key]
                store[key] = (EllGso(np.asarray(v.idx),
                                     np.asarray(v.val).astype(dataType))
                              if isinstance(v, EllGso)
                              else np.asarray(v).astype(dataType))
        super().astype(dataType)

    def expandDims(self):
        pass  # the flocking signals already carry their feature axis

    expand_dims = expandDims

    def saveVideo(self, saveDir, pos, *args, **kwargs):
        """Snapshots of the first trajectory of `pos` ((B,) T x 2 x N) as
        PNG frames (about 25) in `saveDir`, encoded to
        ``trajectory.mp4`` when ffmpeg is on the PATH (reference
        dataTools.py:3701 shells out to it the same way). Returns the
        paths written, or None without matplotlib (imported here only)."""
        import os
        import shutil
        import subprocess
        os.makedirs(saveDir, exist_ok=True)
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return None
        pos = (pos.detach().cpu().numpy() if isinstance(pos, torch.Tensor)
               else np.asarray(pos))
        if pos.ndim == 3:
            pos = pos[None]
        sample = pos[0]                               # T x 2 x N
        step = max(len(sample) // 25, 1)
        paths = []
        for i, t in enumerate(range(0, len(sample), step)):
            fig, ax = plt.subplots(figsize=(4, 4))
            ax.scatter(sample[t, 0], sample[t, 1], s=8)
            ax.set_title(f"t = {t}")
            p = os.path.join(saveDir, f"frame{i:03d}.png")
            fig.savefig(p)
            plt.close(fig)
            paths.append(p)
        if shutil.which("ffmpeg"):
            video = os.path.join(saveDir, "trajectory.mp4")
            try:
                subprocess.run(
                    ["ffmpeg", "-y", "-framerate", "8", "-i",
                     os.path.join(saveDir, "frame%03d.png"),
                     "-pix_fmt", "yuv420p", video],
                    check=True, capture_output=True, timeout=120)
                paths.append(video)
            except (OSError, subprocess.SubprocessError):
                pass   # the frames stand without the video
        return paths

    save_video = saveVideo
