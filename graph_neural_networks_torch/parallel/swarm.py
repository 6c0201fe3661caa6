"""Node-sharded large-swarm environment: closed-loop flocking across a
device mesh.

The port of the JAX package's ``parallel/swarm.py``, in its two modes: the
cell-list grid (``data.flocking.env_step_grid``) and the all-pairs env
(``data.flocking.env_step_chunked``). Each shard owns a block of agents.

All-pairs mode (``env_grid=None``): the swarm is all-gathered once on each
distinct device, and each shard computes its OWN rows against it, in
sub-chunks of ``env_chunk`` rows (``_chunk_env_rows``, the one-card
chunked env's row pass: the first d_max set bits by ``_env_topk``, the
states, and a payload's shift as the masked product M @ payload);
lambda_max comes from the mesh-wide ELL power iteration below. ``ok`` is
always True.

Grid mode, per step:

  * the swarm's positions and velocities (and the policy's registers, as
    payload) are all-gathered, and the cell table is built from the whole
    swarm once on each distinct device of the mesh (``table_build``); the
    shards on that device share it. Each JAX chip builds the same table;
    on one card the port builds it once;
  * each shard runs the window pass (``grid_window``) on its OWN rows
    only: its rows of the communication graph (top-D ELL rows with global
    ids), the 6-feature states, the power-iteration matvec and the
    payload's graph shift;
  * lambda_max comes from a mesh-wide power iteration whose norms and
    dot products sum the shards' partials (JAX's psum): at d_max = 0 by
    window passes (each rewrites the shared tables' v lanes once a
    device, before any shard's pass), at d_max > 0 by ELL matvecs over
    the emitted rows (``env_step_grid(lam_path="ell")`` is its one-shard
    form).

``sharded_swarm_rollout`` closes the loop: the policy's step interface
with its registers riding the env step (``step_mode``), or the windowed
policy over a ``ShardedEllGso`` history, or either reduced to the
flocking cost (``return_cost``). Single-controller: one process drives
every shard, the tensors are global ones on the mesh's home device, and
each shard's slice runs on its device.

One divergence from the JAX package (ROADMAP queue 3): in cost mode the
fused rollout runs the env eval-shaped (d_max = 0, no selection), and JAX
then drops its in-degree check; the port keeps the window pass's count
and returns ok False when an agent's in-degree exceeds d_max, the degree
a deployment with graphs would cut at.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from graph_neural_networks_torch.data import flocking as F
from graph_neural_networks_torch.data.base import ZERO_TOL
from graph_neural_networks_torch.ops.ell import EllGso, ell_shift_rows
from graph_neural_networks_torch.parallel.db import ShardedEllGso
from graph_neural_networks_torch.parallel.mesh import Mesh

__all__ = ["sharded_env_step", "sharded_swarm_rollout", "pad_swarm"]

def pad_swarm(pos, vel, mesh: Mesh, axis: str = "graph",
              spacing: float = 1e3):
    """Pad (B,2,N) positions/velocities to a multiple of the mesh axis
    size. Pad agents are parked on a distant line `spacing` apart (no edge
    to the swarm or to each other: a cluster of pads would form a dense
    component of its own and corrupt the lambda_max normalization) with
    zero velocity. Returns (pos_pad, vel_pad, n_orig), f32 tensors on the
    mesh's home device."""
    pos, vel = np.asarray(pos, np.float64), np.asarray(vel, np.float64)
    B, _, N = pos.shape
    n_pad = (-N) % mesh.shape[axis]
    if n_pad:
        far = np.abs(pos).max() + spacing
        px = far + spacing * np.arange(1, n_pad + 1)
        pp = np.stack([px, np.full(n_pad, far)])[None].repeat(B, 0)
        pos = np.concatenate([pos, pp], axis=-1)
        vel = np.concatenate([vel, np.zeros((B, 2, n_pad))], axis=-1)
    as_t = lambda a: torch.as_tensor(a, device=mesh.home).to(torch.float32)
    return as_t(pos), as_t(vel), N


def sharded_env_step(pos, vel, comm_radius, d_max, mesh: Mesh,
                     axis: str = "graph", v_prev=None, lam_iters: int = 8,
                     env_chunk=None, env_grid=None, payload=None):
    """One env step on node-sharded (B,2,N_pad) pos/vel (global tensors on
    the mesh's home device, N_pad a multiple of the mesh axis size:
    :func:`pad_swarm`). Returns (idx (B,N_pad,D) int32 with global ids,
    val_norm (B,N_pad,D), states (B,6,N_pad), v (B,N_pad)[, shifted
    (B,N_pad,Pw)], deg (B,), ok), each shard's rows computed on its
    device and gathered on the home device.

    env_grid None: the all-pairs env, each shard's rows against the
    gathered swarm in sub-chunks of env_chunk rows (fitted to divide a
    shard's rows; None: the whole shard at once); equal to
    ``env_step_chunked``'s step up to float association, lambda by the ELL
    power iteration, ok always True. env_grid: True or (table_size,
    cell_cap[, cell_factor]), as for the single-chip grid env, which
    env_chunk does not sub-chunk (JAX's rule); equal to
    ``env_step_grid``'s step up to float association when d_max covers
    the largest in-degree: the window lambda at d_max = 0, the ELL lambda
    (lam_path 'ell') at d_max > 0. payload (B,N_pad,Pw): its NORMALIZED
    graph shift (W/lambda) @ payload comes back as ``shifted`` (the fused
    policy's register shift; in all-pairs mode the masked product of the
    untruncated mask). d_max = 0 on the grid: eval-shaped (zero-width
    idx/val, no selection, the window lambda with v_prev on the tables:
    lam_iters = 0 is the Rayleigh fold, each further iteration one window
    pass a shard). deg: each sample's largest true in-degree, int32,
    before any d_max cut. ``ok`` (a 0-d bool tensor) is False iff a cell
    overflowed cell_cap, or, with a payload and d_max > 0 on the grid, an
    in-degree exceeded d_max."""
    B, _, N = pos.shape
    home = pos.device
    devs = mesh.grid(axis)[0]
    if N % len(devs):
        raise ValueError(f"{N} agents do not split into {len(devs)} "
                         "shards; pad the swarm with pad_swarm")
    Np = N // len(devs)
    r2 = comm_radius ** 2
    n_pay = 0 if payload is None else int(payload.shape[-1])
    win_lam = env_grid is not None and d_max == 0
    if v_prev is None:
        v_prev = pos.new_ones((B, N)) / math.sqrt(N)
    uniq = list(dict.fromkeys(devs))

    if env_grid is None:
        # the all-gather, once on each distinct device
        gathered = {dev: (pos.to(dev), vel.to(dev),
                          payload.to(dev) if n_pay else None)
                    for dev in uniq}
        chunk = Np if env_chunk is None else F._fit_chunk(Np, env_chunk)

        def shard_rows(p, dev):
            """Shard p's own rows against the gathered swarm, in
            sub-chunks: (idx, val01, states, cnt, shifted payload)."""
            p_, u_, pay_ = gathered[dev]
            parts = [F._chunk_env_rows(p_, u_, lo, lo + chunk, r2, d_max,
                                       payload=pay_)
                     for lo in range(p * Np, (p + 1) * Np, chunk)]
            cat = lambda k, dim: torch.cat([t[k] for t in parts], dim)
            return (cat(0, 1), cat(1, 1), cat(2, -1), cat(3, 1),
                    cat(4, 1) if n_pay else None)

        main = [shard_rows(p, dev) for p, dev in enumerate(devs)]
        idx, val, st, cnt, wpay = (list(t) for t in zip(*main))
        ok = torch.ones((), dtype=torch.bool, device=home)
    else:
        gts, gcc, gcf = F._parse_env_grid(env_grid)
        H, Gx, Gy, C = F._grid_geometry(N, gts, gcc, gcf)
        inv_s = 1.0 / (gcf * comm_radius)
        # the all-gather and the cell table, once on each distinct device
        tables = {}
        for dev in uniq:
            p_, u_ = pos.to(dev), vel.to(dev)
            table, cx, cy, ok, (order, vpos) = F._grid_build_table(
                p_[:, 0], p_[:, 1], u_[:, 0], u_[:, 1], inv_s, H, Gx, Gy, C,
                v=v_prev.to(dev) if win_lam else None,
                pay=payload.to(dev) if n_pay else None)
            tables[dev] = dict(pos=p_, vel=u_, table=table, cx=cx, cy=cy,
                               ok=ok, order=order, vpos=vpos)

        def rows(p, dev, **kw):
            """The window pass of shard p's own rows on its device's
            table."""
            t = tables[dev]
            sl = slice(p * Np, (p + 1) * Np)
            return F._grid_rows(t["pos"][:, 0, sl], t["pos"][:, 1, sl],
                                t["vel"][:, 0, sl], t["vel"][:, 1, sl],
                                t["cx"][:, sl], t["cy"][:, sl], t["table"],
                                Gx, Gy, C, r2, d_max, inv_s=inv_s,
                                factor=gcf, lo=p * Np, **kw)

        main = [rows(p, dev, n_pay=n_pay) for p, dev in enumerate(devs)]
        idx, val, st, wv, cnt, wpay = (list(t) for t in zip(*main))
        oks = [t["ok"].all() for t in tables.values()]
        if n_pay and d_max > 0:
            oks += [c.amax() <= d_max for c in cnt]
        ok = torch.stack([o.to(home) for o in oks]).all()

    def psum(parts):
        """The shards' (B,) partials summed on the home device."""
        total = parts[0].to(home)
        for t in parts[1:]:
            total = total + t.to(home)
        return total

    def dot(a, b):
        return psum([(x * y).sum(-1) for x, y in zip(a, b)])

    def nrm(ws):
        scale = torch.clamp_min(torch.sqrt(dot(ws, ws)), ZERO_TOL)
        return [w / scale.to(w.device)[:, None] for w in ws]

    def gather(vbs):
        """The all-gather of v's blocks, once a device."""
        return {dev: torch.cat([v.to(dev) for v in vbs], dim=1)
                for dev in uniq}

    v0 = [v_prev[:, p * Np:(p + 1) * Np].to(dev)
          for p, dev in enumerate(devs)]
    if win_lam:
        def matvec(vbs):
            # the shared tables' v lanes, rewritten once a device before
            # any shard's pass (the next step rebuilds the tables)
            for dev, vf in gather(vbs).items():
                t = tables[dev]
                t["table"].view(B, -1).scatter_(
                    1, t["vpos"], torch.gather(vf, 1, t["order"]))
            return [rows(p, dev, wv_only=True) for p, dev in enumerate(devs)]

        lam, v = F._window_lambda(v0, wv, matvec, lam_iters, nrm, dot)
    else:
        ells = [EllGso(i, s[:, None]) for i, s in zip(idx, val)]

        def matvec(vbs):
            full = gather(vbs)
            return [ell_shift_rows(full[dev][..., None, None], e)[..., 0, 0]
                    for dev, e in zip(devs, ells)]

        lam, v = F._ell_lambda(v0, matvec, lam_iters, nrm, dot)

    cat = lambda parts, dim: torch.cat([t.to(home) for t in parts], dim)
    lam3 = lam[:, None, None]
    out = (cat(idx, 1), cat(val, 1) / lam3, cat(st, -1), cat(v, 1))
    if n_pay:
        out = out + (cat(wpay, 1) / lam3,)
    deg = torch.stack([c.amax(dim=1).to(home) for c in cnt]).amax(dim=0)
    return out + (deg.to(torch.int32), ok)


def _rollout_pieces(w, policy, comm_radius, dt, accel_max, d_max,
                    mesh: Mesh, axis, n_orig, lam_iters, env_grid,
                    step_mode, return_cost, env_chunk=None):
    """init/step closures of the sharded closed loop (as
    ``Flocking._chunked_pieces`` for one chip). carry = (pos, vel, x_t,
    history: (policy state, shifted registers) in step mode, (x, idx, val)
    windows else, v, pad mask, largest in-degree, ok); a step emits (pos,
    vel, accel, states, idx, val)."""
    if step_mode and not (hasattr(policy, "rollout_step_shifted")
                          and hasattr(policy, "rollout_payload")
                          and getattr(policy, "E", None) == 1
                          and getattr(policy, "payload_width", 0) > 0):
        raise ValueError("step_mode needs a payload-capable DB architecture "
                         "(rollout_step_shifted, rollout_payload, E == 1)")
    # the fused cost rollout on the grid never reads a graph: the env runs
    # eval-shaped
    d_env = (0 if (return_cost and step_mode and env_grid is not None)
             else d_max)

    def env(pos, vel, v, iters, payload=None):
        *out, deg, ok = sharded_env_step(
            pos, vel, comm_radius, d_env, mesh, axis, v_prev=v,
            lam_iters=iters, env_chunk=env_chunk, env_grid=env_grid,
            payload=payload)
        deg = deg.amax()
        if payload is not None and d_env == 0:
            # the fused shift sums every neighbour; a graph cut at d_max
            # would not (JAX drops this check at d_env = 0)
            ok = ok & (deg <= d_max)
        return out, deg, ok

    def init_fn(init_pos, init_vel):
        B, _, Npad = init_pos.shape
        n_eff = Npad if n_orig is None else n_orig
        mask = (torch.arange(Npad, device=init_pos.device) < n_eff).to(
            init_pos.dtype)[None, None]
        v = init_pos.new_ones((B, Npad)) / math.sqrt(Npad)
        (i0, s0, x0, v), deg, ok = env(init_pos, init_vel, v,
                                       max(lam_iters, 32))
        if step_mode:
            pstate = policy.rollout_init(B, Npad)
            # zero registers shift to zero: no payload pass at init
            hist = (pstate, torch.zeros_like(
                policy.rollout_payload(pstate).reshape(B, Npad, -1)))
        else:
            xw = x0.new_zeros((B, w) + tuple(x0.shape[1:]))
            iw = i0.new_zeros((B, w) + tuple(i0.shape[1:]))
            vw = s0.new_zeros((B, w, 1) + tuple(s0.shape[1:]))
            xw[:, -1], iw[:, -1], vw[:, -1, 0] = x0, i0, s0
            hist = (xw, iw, vw)
        return ((init_pos, init_vel, x0, hist, v, mask, deg, ok),
                (x0, i0, s0))

    def step_fn(carry):
        pos_t, vel_t, x_t, hist, v, mask, deg, ok = carry
        B, _, Npad = pos_t.shape
        if step_mode:
            pstate, y = policy.rollout_step_shifted(hist[0], x_t, hist[1])
        else:
            xw, iw, vw = hist
            y = policy(xw, ShardedEllGso(iw, vw, mesh, axis,
                                         n_orig=Npad))[:, -1]
        a = torch.clamp(y, -accel_max, accel_max) * mask
        vel_n = a * dt + vel_t
        pos_n = a * dt * dt / 2 + vel_t * dt + pos_t
        if step_mode:
            pay = policy.rollout_payload(pstate).reshape(B, Npad, -1)
            (i_n, s_n, x_n, v, sh), deg_n, ok_n = env(
                pos_n, vel_n, v, lam_iters, payload=pay)
            hist = (pstate, sh)
        else:
            (i_n, s_n, x_n, v), deg_n, ok_n = env(pos_n, vel_n, v,
                                                  lam_iters)
            hist = (torch.cat([xw[:, 1:], x_n[:, None]], dim=1),
                    torch.cat([iw[:, 1:], i_n[:, None]], dim=1),
                    torch.cat([vw[:, 1:], s_n[:, None, None]], dim=1))
        carry = (pos_n, vel_n, x_n, hist, v, mask, torch.maximum(deg, deg_n),
                 ok & ok_n)
        return carry, (pos_n, vel_n, a, x_n, i_n, s_n)

    return init_fn, step_fn


def sharded_swarm_rollout(T: int, w: int, policy, comm_radius: float,
                          dt: float, accel_max: float, d_max: int,
                          mesh: Mesh, axis: str = "graph", n_orig=None,
                          lam_iters: int = 8, env_chunk=None, env_grid=None,
                          step_mode: bool = False,
                          return_cost: bool = False):
    """A closed-loop rollout over the mesh (JAX ``sharded_swarm_rollout``)
    on the grid (env_grid) or the all-pairs env (env_grid None, each
    shard's rows in sub-chunks of env_chunk): ``rollout(pos_pad,
    vel_pad)`` on :func:`pad_swarm`'s tensors, run under
    ``torch.no_grad()``. Pad agents' accelerations are zeroed (pads never
    move), so the first n_orig agents follow the unpadded rollout.

    policy: with step_mode=False, the windowed policy ``policy(x_hist
    (B,w,6,N_pad), S_hist) -> (B,w,2,N_pad)`` over the last w steps'
    states and graphs (``S_hist`` a ShardedEllGso with leading (B, w); a
    LocalGNN_DB module is one, with w = its causal_window). step_mode=True
    (a payload-capable DB architecture with one edge feature): the fused
    rollout, the policy's registers riding the env step as payload and
    shifted by its window pass (``rollout_step_shifted``), no history.

    Returns (pos, vel, accel, states, graphs ShardedEllGso (idx
    (B,T,N_pad,D), val (B,T,1,N_pad,D)), deg, ok), all (B,T,...) on the
    home device; accel[:, T-1] is zero. return_cost=True: (cost_full,
    cost_end, deg, ok) 0-d tensors, the flocking cost over the
    trajectory and at its end (pad agents masked out) accumulated step by
    step, nothing O(T·N) kept. The fused cost rollout on the grid runs
    the env eval-shaped (d_max = 0: no selection, the window lambda) and
    flags ok False when an in-degree exceeds d_max, where the fused shift
    (which sums every neighbour) and a graph cut at d_max differ (module
    docstring). deg: the largest true in-degree seen (0-d int32)."""
    init_fn, step_fn = _rollout_pieces(
        w, policy, comm_radius, dt, accel_max, d_max, mesh, axis, n_orig,
        lam_iters, env_grid, step_mode, return_cost, env_chunk)

    @torch.no_grad()
    def rollout(init_pos, init_vel):
        B, _, Npad = init_pos.shape
        n_eff = Npad if n_orig is None else n_orig
        carry, (x0, i0, s0) = init_fn(init_pos, init_vel)
        mask = carry[5]

        def stepcost(vel):                            # (B,2,Npad) -> (B,)
            vbar = (vel * mask).sum(-1, keepdim=True) / n_eff
            d = (vel - vbar) * mask
            return (d * d).sum((1, 2)) / n_eff

        if return_cost:
            acc = last = stepcost(init_vel)
        else:
            pos = init_pos.new_empty((B, T, 2, Npad))
            vel = init_pos.new_empty((B, T, 2, Npad))
            accel = init_pos.new_zeros((B, T, 2, Npad))
            states = init_pos.new_empty((B, T, 6, Npad))
            gi = i0.new_empty((B, T) + tuple(i0.shape[1:]))
            gv = s0.new_empty((B, T) + tuple(s0.shape[1:]))
            pos[:, 0], vel[:, 0], states[:, 0] = init_pos, init_vel, x0
            gi[:, 0], gv[:, 0] = i0, s0
        for t in range(1, T):
            carry, (pos_n, vel_n, a, x_n, i_n, s_n) = step_fn(carry)
            if return_cost:
                last = stepcost(vel_n)
                acc = acc + last
            else:
                pos[:, t], vel[:, t], accel[:, t - 1] = pos_n, vel_n, a
                states[:, t], gi[:, t], gv[:, t] = x_n, i_n, s_n
        tail = carry[6:]                              # deg, ok
        if return_cost:
            return (acc.mean(), last.mean()) + tail
        graphs = ShardedEllGso(gi, gv[:, :, None], mesh, axis, n_orig=Npad)
        return (pos, vel, accel, states, graphs) + tail

    return rollout
