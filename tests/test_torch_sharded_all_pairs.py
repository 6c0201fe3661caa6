"""PyTorch port, parallel/swarm.py's all-pairs mode (env_grid=None): the
sharded env step (each shard's rows against the gathered swarm, in
env_chunk sub-chunks, the payload's shift as a masked product, lambda by
the mesh-wide ELL power iteration) and the closed-loop sharded rollouts
(windowed, fused step mode, cost; a GraphRecurrentNN_DB as the windowed
policy), held against the JAX package on the CPU with the same inputs and
weights and against the port's one-card chunked env and rollout.

The port's meshes repeat the CPU device; the JAX side runs on the 8
virtual CPU devices of tests/conftest.py, jitted. Exact: selected neighbor
ids, the flags, pad agents' positions. Env steps: values, states and the
eigenvector at rtol 1e-5 plus 1e-5 of the largest value; rollouts:
positions and velocities at rtol = atol = 1e-4 over 5-6 steps, costs at
rtol 1e-4, as the JAX package's own sharded tests hold them
(tests/test_sharded_db.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from graph_neural_networks_torch import parallel as tpar
from graph_neural_networks_torch.data import flocking as tF
from graph_neural_networks_torch.models import architectures_time as tarcht
from graph_neural_networks_torch.utils.params import load_flax_params
from graph_neural_networks_tpu import parallel as jpar
from graph_neural_networks_tpu.models import architectures_time as jarcht

from tests.test_torch_flocking import _close
from tests.test_torch_parallel import meshes  # noqa: F401 (a fixture)
from tests.test_torch_sharded_swarm import TOL
from tests.test_torch_sharded_swarm_rollout import _rollout_setup


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine: one intra-op thread
    keeps the many small torch ops here from oversubscribing its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


STEP = dict(rtol=1e-5, atol_rel=1e-5)
T_ROLL = 6


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("N,env_chunk,P", [(12, None, 0), (12, 1, 5),
                                           (10, 2, 0)])
def test_sharded_all_pairs_step_matches_jax_and_one_card(meshes, N,
                                                         env_chunk, P):
    """One all-pairs sharded step on the (2, 4) mesh (N = 10 padded to 12),
    sub-chunked or not, with a payload: against the JAX sharded step and
    the port's one-card chunked step; ok True, deg the largest in-degree."""
    tmesh, jmesh = meshes[(2, 4)]
    env, ip, iv, *_ = _rollout_setup(N)
    tp, tv, n_orig = tpar.pad_swarm(ip, iv, tmesh)
    jp, jv, _ = jpar.pad_swarm(ip, iv, jmesh)
    Np = tp.shape[-1]
    rng = np.random.default_rng(N + P)
    v0 = np.abs(rng.normal(size=(2, Np))).astype(np.float32)
    pay = rng.normal(size=(2, Np, P)).astype(np.float32) if P else None
    got = tpar.sharded_env_step(tp, tv, 6.0, Np, tmesh, v_prev=_t(v0),
                                lam_iters=16, env_chunk=env_chunk,
                                payload=None if pay is None else _t(pay))
    with jmesh:
        want = jax.jit(lambda p, u, v, *pl: jpar.sharded_env_step(
            p, u, 6.0, Np, jmesh, v_prev=v, lam_iters=16,
            env_chunk=env_chunk, payload=pl[0] if pl else None))(
                jp, jv, jnp.asarray(v0),
                *(() if pay is None else (jnp.asarray(pay),)))
    one = tF.env_step_chunked(tp, tv, 6.0, Np, Np, _t(v0), lam_iters=16)
    assert bool(got[-1]) and bool(want[-1])
    M = np.zeros((2, Np, Np))
    for b in range(2):
        np.add.at(M[b], (np.arange(Np)[:, None].repeat(Np, 1),
                         got[0][b].numpy()), (got[1][b] > 0).numpy())
    np.testing.assert_array_equal(got[-2].numpy(), M.sum(-1).max(-1))
    for ref in (want, one):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
        _close(got[1].numpy(), ref[1], **STEP)
        _close(got[2].numpy(), ref[2], axis=1, **STEP)
        _close(got[3].numpy(), ref[3], **STEP)
    if P:
        _close(got[4].numpy(), want[4], axis=-1, **STEP)
        lam = 1.0 / got[1].amax(dim=(1, 2)).numpy()
        _close(got[4].numpy(), np.einsum("bmn,bnp->bmp", M, pay)
               / lam[:, None, None], axis=-1, **STEP)


MODES = {  # mode: (step_mode, return_cost)
    "windowed": (False, False), "fused": (True, False),
    "fused_cost": (True, True),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_sharded_all_pairs_rollout_matches_jax_and_one_card(meshes, mode):
    """sharded_swarm_rollout(env_grid=None) on the (2, 4) mesh, N = 10 (two
    pad agents), against the JAX one and the port's one-card chunked
    rollout (windowed, or step mode: unfused on one card, where the mesh
    fuses the payload by the masked product), d_max covering every
    in-degree (JAX tests/test_sharded_db.py:143, :192, :267)."""
    tmesh, jmesh = meshes[(2, 4)]
    N = 10
    env, ip, iv, jnet, params, tnet = _rollout_setup(N)
    step_mode, return_cost = MODES[mode]
    w = jnet.causal_window
    kw = dict(d_max=N, lam_iters=64, env_chunk=2, step_mode=step_mode,
              return_cost=return_cost)
    jpol = jnet if step_mode else (
        lambda p, xw, Sw: jnet.apply(p, jnp.asarray(xw, jnp.float32), Sw))
    jp, jv, n_orig = jpar.pad_swarm(ip, iv, jmesh)
    want = jpar.sharded_swarm_rollout(
        T_ROLL, w, jpol, env.commRadius, env.samplingTime, env.accelMax,
        mesh=jmesh, n_orig=n_orig, **kw)(params, jp, jv)
    tp, tv, _ = tpar.pad_swarm(ip, iv, tmesh)
    got = tpar.sharded_swarm_rollout(
        T_ROLL, w, tnet, env.commRadius, env.samplingTime, env.accelMax,
        mesh=tmesh, n_orig=n_orig, **kw)(tp, tv)
    assert bool(got[-1])
    tenv = tF.Flocking.for_rollout(N, 6.0, 1.0, 0.125, device="cpu")
    one_kw = dict(ell_degree=N, env_chunk=5, lam_iters=64,
                  step_mode=step_mode, history_window=w)
    if return_cost:
        np.testing.assert_allclose([float(got[0]), float(got[1])],
                                   [float(want[0]), float(want[1])],
                                   rtol=1e-4)
        one = tenv.rollout_cost(ip, iv, T_ROLL * 0.125, tnet, **one_kw)
        np.testing.assert_allclose([float(got[0]), float(got[1])], one,
                                   rtol=1e-4)
        return
    pos, vel, accel, states, graphs = got[:5]
    assert isinstance(graphs, tpar.ShardedEllGso)
    for a, b in ((pos, want[0]), (vel, want[1]), (accel, want[2])):
        np.testing.assert_allclose(a.numpy()[..., :N],
                                   np.asarray(b)[..., :N], **TOL)
    _close(states.numpy()[..., :N], np.asarray(want[3])[..., :N], rtol=1e-4,
           axis=2)
    np.testing.assert_array_equal(graphs.idx.numpy(),
                                  np.asarray(want[4].idx))
    one = tenv.compute_trajectory(ip, iv, T_ROLL * 0.125, tnet, **one_kw)
    np.testing.assert_allclose(pos.numpy()[..., :N], one[0], **TOL)
    np.testing.assert_allclose(vel.numpy()[..., :N], one[1], **TOL)
    pp = pos.numpy()[..., N:]                      # pad agents never move
    np.testing.assert_array_equal(pp, np.broadcast_to(pp[:, :1], pp.shape))


def test_sharded_all_pairs_grnn_policy_matches_one_card(meshes):
    """GraphRecurrentNN_DB as the windowed policy (w = 3, z0 zeros) on the
    all-pairs mesh env against the one-card chunked windowed rollout and
    the JAX sharded one (JAX tests/test_sharded_db.py:233)."""
    tmesh, jmesh = meshes[(2, 4)]
    N, T = 12, 5
    env, ip, iv, *_ = _rollout_setup(N, seed=1)
    ip, iv = ip[:1], iv[:1]
    jnet = jarcht.GraphRecurrentNN_DB(6, 4, 8, [2, 2], True, "tanh", "tanh",
                                      "tanh", [2], 1)
    params = jax.jit(lambda k: jnet.init(k, N=N, T=2))(
        jax.random.PRNGKey(0))
    tnet = tarcht.GraphRecurrentNN_DB(6, 4, 8, [2, 2], True, "tanh", "tanh",
                                      "tanh", [2], 1, device="cpu")
    load_flax_params(tnet, jax.tree_util.tree_map(np.asarray,
                                                  unfreeze(params)))
    tpol = lambda xw, Sw: tnet(xw, Sw, z0=torch.zeros(1, 8, xw.shape[-1]))

    def jpol(p, xw, Sw):
        z0 = jnp.zeros((1, 8, xw.shape[-1]), jnp.float32)
        return jnet.apply(p, jnp.asarray(xw, jnp.float32), Sw, z0=z0)

    tenv = tF.Flocking.for_rollout(N, 6.0, 1.0, 0.125, device="cpu")
    one = tenv.rollout_traj_device(ip, iv, T * 0.125, tnet,
                                   history_window=3, ell_degree=N,
                                   env_chunk=6, lam_iters=64,
                                   step_mode=False)
    tp, tv, n_orig = tpar.pad_swarm(ip, iv, tmesh)
    got = tpar.sharded_swarm_rollout(T, 3, tpol, 6.0, 0.125, 10.0, N, tmesh,
                                     n_orig=n_orig, lam_iters=64)(tp, tv)
    jp, jv, _ = jpar.pad_swarm(ip, iv, jmesh)
    want = jpar.sharded_swarm_rollout(T, 3, jpol, 6.0, 0.125, 10.0, N,
                                      jmesh, n_orig=n_orig,
                                      lam_iters=64)(params, jp, jv)
    for a, b in ((got[0], want[0]), (got[1], want[1])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    # the one-card module draws its own z0 (the generator-0 draw): the
    # same rollout with that z0 through the mesh
    z = tnet.rollout_init(1, N)[1].transpose(-1, -2)
    got_z = tpar.sharded_swarm_rollout(
        T, 3, lambda xw, Sw: tnet(xw, Sw, z0=z), 6.0, 0.125, 10.0, N, tmesh,
        n_orig=n_orig, lam_iters=64)(tp, tv)
    np.testing.assert_allclose(got_z[0].numpy(), one[0].numpy(), **TOL)
    np.testing.assert_allclose(got_z[1].numpy(), one[1].numpy(), **TOL)
