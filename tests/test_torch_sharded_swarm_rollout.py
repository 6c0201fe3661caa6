"""PyTorch port, parallel/swarm.py's closed-loop sharded rollouts (fused,
cost and windowed) on the grid and what its sharded env refuses, held against the
JAX package on the CPU with the same inputs and weights (moved from
tests/test_torch_sharded_swarm.py, whose helpers they use).

The port's meshes repeat the CPU device; the JAX side runs on the 8
virtual CPU devices of tests/conftest.py (its rollouts are jitted by
sharded_swarm_rollout itself). Exact: selected neighbor ids, the
exactness flags, pad agents' positions. Rollouts: positions and
velocities at rtol = atol = 1e-4 over 6 steps, costs at rtol 1e-4, as the
JAX package's own sharded tests hold them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_neural_networks_torch import parallel as tpar
from graph_neural_networks_torch.data import flocking as tF
from graph_neural_networks_tpu import parallel as jpar
from graph_neural_networks_tpu.data import flocking as jF

from tests.test_torch_flocking import _close
from tests.test_torch_parallel import meshes  # noqa: F401 (a fixture)
from tests.test_torch_sharded_swarm import TOL, _transplanted


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine: one intra-op thread
    keeps the many small torch ops here from oversubscribing its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Closed-loop rollouts
# ---------------------------------------------------------------------------

def _rollout_setup(N, seed=1):
    """The JAX sharded tests' swarm (commRadius 6, dt 0.125, 2 samples)
    and a transplanted LocalGNN_DB([6, 8], [2])."""
    env = jF.Flocking.for_rollout(N, commRadius=6.0, repelDist=1.0,
                                  samplingTime=0.125,
                                  rng=np.random.default_rng(seed))
    ip, iv = env.compute_initial_positions(
        N, 2, env.commRadius, minDist=env.initMinDist, geometry="circular",
        xMaxInitVel=3.0, yMaxInitVel=3.0)
    jnet, params, tnet = _transplanted([6, 8], [2], 0, N=N)
    return env, ip, iv, jnet, params, tnet


GRID = (256, 16)
T_ROLL = 6
MODES = {  # mode: (step_mode, return_cost)
    "fused": (True, False), "fused_cost": (True, True),
    "windowed": (False, False), "windowed_cost": (False, True),
}


@pytest.mark.parametrize("mode,N", [(m, n) for m in MODES for n in (12, 10)
                                    if not (m == "windowed_cost" and n == 10)])
def test_sharded_rollout_matches_jax(meshes, mode, N):
    """sharded_swarm_rollout against the JAX one on the (2, 4) mesh, N = 12
    and N = 10 (two pad agents), d_max = N covering every in-degree."""
    tmesh, jmesh = meshes[(2, 4)]
    env, ip, iv, jnet, params, tnet = _rollout_setup(N)
    step_mode, return_cost = MODES[mode]
    w = jnet.causal_window
    kw = dict(d_max=N, lam_iters=64, env_grid=GRID, step_mode=step_mode,
              return_cost=return_cost)
    jpol = jnet if step_mode else (
        lambda p, xw, Sw: jnet.apply(p, jnp.asarray(xw, jnp.float32), Sw))
    jp, jv, n_orig = jpar.pad_swarm(ip, iv, jmesh)
    want = jpar.sharded_swarm_rollout(
        T_ROLL, w, jpol, env.commRadius, env.samplingTime, env.accelMax,
        mesh=jmesh, n_orig=n_orig, **kw)(params, jp, jv)
    tp, tv, n_orig_t = tpar.pad_swarm(ip, iv, tmesh)
    assert n_orig_t == n_orig == N
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    got = tpar.sharded_swarm_rollout(
        T_ROLL, w, tnet, env.commRadius, env.samplingTime, env.accelMax,
        mesh=tmesh, n_orig=n_orig, **kw)(tp, tv)
    assert bool(got[-1]) and bool(want[-1])
    if return_cost:
        np.testing.assert_allclose([float(got[0]), float(got[1])],
                                   [float(want[0]), float(want[1])],
                                   rtol=1e-4)
        return
    pos, vel, accel, states, graphs = got[:5]
    assert isinstance(graphs, tpar.ShardedEllGso)
    assert tuple(graphs.idx.shape) == (2, T_ROLL, tp.shape[-1], N)
    for a, b in ((pos, want[0]), (vel, want[1]), (accel, want[2])):
        np.testing.assert_allclose(a.numpy()[..., :N],
                                   np.asarray(b)[..., :N], **TOL)
    _close(states.numpy()[..., :N], np.asarray(want[3])[..., :N], rtol=1e-4,
           axis=2)
    np.testing.assert_array_equal(graphs.idx.numpy(),
                                  np.asarray(want[4].idx))
    pp = pos.numpy()[..., N:]                      # pad agents never move
    np.testing.assert_array_equal(pp, np.broadcast_to(pp[:, :1], pp.shape))


def test_cost_mode_flags_an_in_degree_above_d_max(meshes):
    """The port's divergence from the JAX package (ROADMAP queue 3): the
    fused cost rollout runs the env eval-shaped (d_max = 0) in both, and
    JAX then drops the in-degree check; the port keeps the window pass's
    count and returns ok False when an in-degree (6 here) exceeds d_max =
    4, the degree a deployment with graphs would cut at. Costs are those
    of d_max = 12."""
    tmesh, jmesh = meshes[(2, 4)]
    env, ip, iv, jnet, params, tnet = _rollout_setup(12)
    tp, tv, n_orig = tpar.pad_swarm(ip, iv, tmesh)
    jp, jv, _ = jpar.pad_swarm(ip, iv, jmesh)
    args = (T_ROLL, jnet.causal_window)
    kw = dict(lam_iters=64, env_grid=GRID, step_mode=True, return_cost=True,
              n_orig=n_orig)
    tail = (env.commRadius, env.samplingTime, env.accelMax)
    cf, ce, deg, ok = tpar.sharded_swarm_rollout(
        *args, tnet, *tail, d_max=4, mesh=tmesh, **kw)(tp, tv)
    cf12, ce12, deg12, ok12 = tpar.sharded_swarm_rollout(
        *args, tnet, *tail, d_max=12, mesh=tmesh, **kw)(tp, tv)
    assert int(deg) == int(deg12) > 4
    assert not bool(ok) and bool(ok12)
    assert (float(cf), float(ce)) == (float(cf12), float(ce12))
    # JAX: the same costs, and ok True at d_max = 4
    jcf, jce, jok = jpar.sharded_swarm_rollout(
        *args, jnet, *tail, d_max=4, mesh=jmesh, **kw)(params, jp, jv)
    assert bool(jok)
    np.testing.assert_allclose([float(cf), float(ce)],
                               [float(jcf), float(jce)], rtol=1e-4)
    # the same flag as the fused rollout with graphs at d_max = 4, whose
    # env checks the payload steps' in-degree itself (as JAX's does)
    traj = tpar.sharded_swarm_rollout(
        *args, tnet, *tail, d_max=4, mesh=tmesh, lam_iters=64,
        env_grid=GRID, step_mode=True, n_orig=n_orig)(tp, tv)
    assert not bool(traj[-1])


def test_sharded_all_pairs_mode_raises_naming_7_3(meshes):
    """The all-pairs mode raised here naming item 7.3 (the name is kept):
    now the sharded step and rollout against the one-card chunked env
    (against JAX: tests/test_torch_sharded_all_pairs.py), env_chunk not
    sub-chunking a grid shard (JAX's rule); what still raises: a step-mode
    policy without the payload interface and an unpadded swarm."""
    tmesh, _ = meshes[(2, 4)]
    env, ip, iv, _, _, tnet = _rollout_setup(12)
    tp, tv, _ = tpar.pad_swarm(ip, iv, tmesh)
    got = tpar.sharded_env_step(tp, tv, 6.0, 12, tmesh, lam_iters=16)
    one = tF.env_step_chunked(tp, tv, 6.0, 12, 4,
                              torch.full((2, 12), 12 ** -0.5), lam_iters=16)
    assert bool(got[-1])
    np.testing.assert_array_equal(got[0].numpy(), one[0].numpy())
    for a, b in zip(got[1:4], one[1:4]):
        _close(a.numpy(), b.numpy(), rtol=1e-5)
    grid = [tpar.sharded_env_step(tp, tv, 6.0, 12, tmesh, env_grid=GRID,
                                  env_chunk=c) for c in (None, 2)]
    for a, b in zip(*grid):
        assert torch.equal(a, b)
    roll = tpar.sharded_swarm_rollout(4, 2, tnet, 6.0, 0.125, 10.0, 12,
                                      tmesh, lam_iters=16)(tp, tv)
    tenv = tF.Flocking.for_rollout(12, 6.0, 1.0, 0.125, device="cpu")
    ref = tenv.rollout_traj_device(ip, iv, 0.5, tnet, history_window=2,
                                   ell_degree=12, env_chunk=4, lam_iters=16,
                                   step_mode=False)
    np.testing.assert_allclose(roll[0].numpy(), ref[0].numpy(), **TOL)
    with pytest.raises(ValueError, match="payload-capable"):
        tpar.sharded_swarm_rollout(4, 2, lambda x, S: x, 6.0, 0.125, 10.0,
                                   12, tmesh, env_grid=GRID, step_mode=True)
    with pytest.raises(ValueError, match="pad_swarm"):
        tpar.sharded_env_step(tp[..., :10], tv[..., :10], 6.0, 12, tmesh,
                              env_grid=GRID)
