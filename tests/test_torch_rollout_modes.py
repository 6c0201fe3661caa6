"""PyTorch port, data/flocking.py's other rollouts: the windowed re-forward
(step_mode=False, on the all-pairs env with dense and ELL graphs, the
chunked env and the grid), the host-segmented rollout (seg=), the host
loop of a plain callable policy (full horizon and windowed) and the open
loop (accel=), held against the JAX package on the CPU with the same
inputs and weights, and against the port's own step mode.

Rollouts (T = 8): positions and velocities at rtol = atol = 1e-4, the
JAX package's own tolerance for them (tests/test_ell.py,
tests/test_rollout_step.py use 1e-4 and 2e-4); states at rtol 1e-4 plus
1e-4 of the channel's largest value. Exact: the selected neighbor ids of
the rollouts against JAX, the segmented rollouts against the monolithic
ones (the same closures, so the same numbers), the open loop (the same
f64 numpy operations). The host loop at rtol = atol = 1e-5 (f64 graphs
and states on both sides, f32 policies).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from graph_neural_networks_torch.data import flocking as tF
from graph_neural_networks_torch.models import architectures_time as tarcht
from graph_neural_networks_torch.ops import ell as tell
from graph_neural_networks_torch.utils.params import load_flax_params
from graph_neural_networks_tpu.data import flocking as jF
from graph_neural_networks_tpu.models import architectures_time as jarcht

from tests.test_torch_flocking import _close


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine: one intra-op thread
    keeps the many small torch ops here from oversubscribing its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-4, atol=1e-4)
DUR = 0.4                       # T = 8 at dt = 0.05
ENVS = {
    "dense": dict(),
    "ell": dict(ell_degree=8),
    "chunked": dict(ell_degree=8, env_chunk=12, lam_method="power",
                    lam_iters=8),
    "grid": dict(ell_degree=16, env_grid=(1024, 64), lam_iters=4),
}


def _envs(N=24, B=2, seed=11):
    """JAX tests/test_rollout_step.py's small swarm (commRadius 2, dt
    0.05), the JAX env and the port's."""
    jenv = jF.Flocking.for_rollout(N, commRadius=2.0, repelDist=1.0,
                                   samplingTime=0.05,
                                   rng=np.random.default_rng(seed))
    tenv = tF.Flocking.for_rollout(N, commRadius=2.0, repelDist=1.0,
                                   samplingTime=0.05, device="cpu",
                                   rng=np.random.default_rng(seed))
    ip, iv = jenv.compute_initial_positions(
        N, B, 2.0, minDist=0.1, geometry="circular", xMaxInitVel=3.0,
        yMaxInitVel=3.0)
    return jenv, tenv, ip, iv


def _jit_init(jnet, seed, N):
    """The JAX init jitted (eager flax init compiles op by op)."""
    return jax.jit(lambda k: jnet.init(k, N=N, T=3))(
        jax.random.PRNGKey(seed))


def _local(seed=5, N=24):
    jnet = jarcht.LocalGNN_DB([6, 8], [3], True, "tanh", [2], 1)
    params = _jit_init(jnet, seed, N)
    tnet = tarcht.LocalGNN_DB([6, 8], [3], True, "tanh", [2], 1,
                              device="cpu")
    load_flax_params(tnet, jax.tree_util.tree_map(np.asarray,
                                                  unfreeze(params)))
    return jnet, params, tnet


@pytest.fixture(scope="module")
def setup():
    return _envs() + _local()


def _same_rollout(got, want, graphs_exact=True):
    for a, b in zip(got[:2], want[:2]):                  # pos, vel
        np.testing.assert_allclose(a, np.asarray(b), **TOL)
    _close(got[2], want[2], rtol=1e-4, atol_rel=1e-4)   # accel
    _close(got[3], want[3], rtol=1e-4, atol_rel=1e-4, axis=2)
    if isinstance(got[4], tell.EllGso) and graphs_exact:
        np.testing.assert_array_equal(got[4].idx, np.asarray(want[4].idx))


@pytest.mark.parametrize("env", list(ENVS))
def test_windowed_rollout_matches_jax_and_step_mode(setup, env):
    """step_mode=False: the windowed re-forward at w = causal_window (3)
    against JAX's on each env, and against the port's step mode (JAX
    tests/test_rollout_step.py:129); rollout_traj_device and rollout_cost
    take the same loop."""
    jenv, tenv, ip, iv, jnet, params, tnet = setup
    kw = dict(history_window=jnet.causal_window, **ENVS[env])
    want = jenv.compute_trajectory(ip, iv, DUR, archit=jnet, params=params,
                                   step_mode=False, **kw)
    got = tenv.compute_trajectory(ip, iv, DUR, tnet, step_mode=False, **kw)
    assert got[0].dtype == np.float64 and got[0].shape == (2, 8, 2, 24)
    _same_rollout(got, want)
    step = tenv.compute_trajectory(ip, iv, DUR, tnet, step_mode=True, **kw)
    for a, b in zip(step[:2], got[:2]):
        np.testing.assert_allclose(a, b, **TOL)
    kw.pop("lam_method", None)
    pos, vel = tenv.rollout_traj_device(ip, iv, DUR, tnet, step_mode=False,
                                        **kw)
    np.testing.assert_allclose(pos.numpy(), got[0], rtol=1e-6, atol=1e-6)
    if env == "chunked":
        cf, _ = tenv.rollout_cost(ip, iv, DUR, tnet, step_mode=False, **kw)
        jcf, _ = jenv.rollout_cost(ip, iv, DUR, jnet, params,
                                   step_mode=False, **kw)
        np.testing.assert_allclose(cf, jcf, rtol=1e-5)


def test_window_zero_padding_is_ignored_by_a_causal_policy(setup):
    """The first w - 1 history slots hold zero states and the all-zero
    graph (idx 0, val 0): the policy's last tap equals the full-history
    forward's at every step of a rollout's first w steps."""
    jenv, tenv, ip, iv, jnet, params, tnet = setup
    kw = dict(ell_degree=8, env_chunk=12, lam_iters=8)
    pos, vel, accel, xs, g = tenv.compute_trajectory(
        ip, iv, DUR, tnet, step_mode=False, history_window=3, **kw)
    with torch.no_grad():
        full = tnet(torch.tensor(xs, dtype=torch.float32),
                    tell.EllGso(torch.tensor(g.idx),
                                torch.tensor(g.val, dtype=torch.float32)))
    np.testing.assert_allclose(accel[:, :-1],
                               full.numpy()[:, :-1].clip(-10, 10),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("env,step_mode", [("chunked", False),
                                           ("chunked", True),
                                           ("grid", False), ("grid", True)])
def test_segmented_rollout_equals_monolithic(setup, env, step_mode):
    """seg=3 over T - 1 = 7 steps (a remainder segment): the same numbers
    as the monolithic rollout, graphs included, on the chunked env and the
    grid (fused step mode there); T = 1 gives the init-only trajectory
    (JAX tests/test_ell.py:500, :597, tests/test_rollout_step.py:310)."""
    jenv, tenv, ip, iv, jnet, params, tnet = setup
    kw = dict(history_window=3, step_mode=step_mode, **ENVS[env])
    mono = tenv.compute_trajectory(ip, iv, DUR, tnet, **kw)
    seg = tenv.compute_trajectory(ip, iv, DUR, tnet, seg=3, **kw)
    for a, b in zip(seg[:4], mono[:4]):
        assert a.dtype == np.float64
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(seg[4].idx, mono[4].idx)
    np.testing.assert_array_equal(seg[4].val, mono[4].val)
    one = tenv.compute_trajectory(ip, iv, 0.04, tnet, seg=3, **kw)
    np.testing.assert_array_equal(one[0], mono[0][:, :1])
    np.testing.assert_array_equal(one[3], mono[3][:, :1])
    assert not one[2].any() and one[4].idx.shape == (2, 1, 24, 8
                                                      if env == "chunked"
                                                      else 16)


def test_segmented_rollout_matches_jax_and_refuses_without_chunks(setup):
    jenv, tenv, ip, iv, jnet, params, tnet = setup
    kw = dict(history_window=3, step_mode=False, **ENVS["chunked"])
    want = jenv.compute_trajectory(ip, iv, DUR, archit=jnet, params=params,
                                   seg=3, **kw)
    got = tenv.compute_trajectory(ip, iv, DUR, tnet, seg=3, **kw)
    _same_rollout(got, want)
    with pytest.raises(ValueError, match="seg= requires env_chunk"):
        tenv.compute_trajectory(ip, iv, DUR, tnet, ell_degree=8, seg=3,
                                history_window=3)
    with pytest.raises(ValueError, match="monolithic only"):
        tenv.compute_trajectory(ip, iv, DUR, tnet, seg=3,
                                return_graphs=False, **ENVS["grid"])


def test_chunked_rollout_matches_dense_and_grid_rollouts(setup):
    """The chunked env's windowed rollout against the dense-env ELL
    rollout (lambda by power iteration) and the grid rollout (JAX
    tests/test_ell.py:459, :597)."""
    jenv, tenv, ip, iv, jnet, params, tnet = setup
    kw = dict(history_window=3, step_mode=False)
    chunk = tenv.compute_trajectory(ip, iv, DUR, tnet, ell_degree=16,
                                    env_chunk=12, lam_iters=64, **kw)
    grid_kw = dict(ENVS["grid"], lam_iters=64)
    dense = tenv.compute_trajectory(ip, iv, DUR, tnet, ell_degree=16,
                                    lam_method="power", **kw)
    grid = tenv.compute_trajectory(ip, iv, DUR, tnet, **grid_kw, **kw)
    for other in (dense, grid):
        np.testing.assert_allclose(chunk[0], other[0], rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(chunk[1], other[1], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("window", [None, 3])
def test_host_loop_matches_jax(setup, window):
    """A plain callable policy takes the host loop (f64 dense graphs by
    eigvalsh, f64 states): full horizon and windowed, against JAX's host
    loop (its policy without params in the compiled sense: jit=False)."""
    jenv, tenv, ip, iv, jnet, params, tnet = setup
    jpol = jax.jit(lambda p, x, S: jnet.apply(
        p, jnp.asarray(x, jnp.float32), jnp.asarray(S, jnp.float32)))
    want = jenv.compute_trajectory(ip, iv, DUR, archit=jpol, params=params,
                                   history_window=window, jit=False)
    got = tenv.compute_trajectory(ip, iv, DUR, lambda x, S: tnet(x, S),
                                  history_window=window)
    for a, b in zip(got, want):
        assert a.dtype == np.float64
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    assert got[4].shape == (2, 8, 24, 24)
    # the module itself takes it with jit=False, and matches its step mode
    mod = tenv.compute_trajectory(ip, iv, DUR, tnet, history_window=window,
                                  jit=False)
    np.testing.assert_array_equal(mod[0], got[0])
    step = tenv.compute_trajectory(ip, iv, DUR, tnet)
    np.testing.assert_allclose(step[0], got[0], **TOL)


def test_grnn_step_mode_matches_host_loop():
    """GraphRecurrentNN_DB has no finite window: step_mode=False without
    history_window is the host loop over the full horizon, and step mode
    reproduces it (z0 the generator-0 draw on both paths); against JAX's
    host loop with its PRNGKey(0) z0 (JAX tests/test_rollout_step.py:151)."""
    jenv, tenv, ip, iv = _envs(N=16, B=1)
    jnet = jarcht.GraphRecurrentNN_DB(6, 2, 4, [3, 3], True, "tanh", "tanh",
                                      "tanh", [2], 1)
    params = _jit_init(jnet, 6, 16)
    tnet = tarcht.GraphRecurrentNN_DB(6, 2, 4, [3, 3], True, "tanh", "tanh",
                                      "tanh", [2], 1, device="cpu")
    load_flax_params(tnet, jax.tree_util.tree_map(np.asarray,
                                                  unfreeze(params)))
    z0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (1, 4, 16)))
    host = tenv.compute_trajectory(
        ip, iv, DUR, lambda x, S: tnet(x, S, z0=torch.tensor(z0)))
    jpol = jax.jit(lambda p, x, S: jnet.apply(p, x, S))   # z0: PRNGKey(0)
    want = jenv.compute_trajectory(ip, iv, DUR, archit=jpol, params=params,
                                   step_mode=False)[0]
    np.testing.assert_allclose(host[0], want, rtol=1e-5, atol=1e-5)
    # the module: the host loop (its forward draws the generator-0 z0, as
    # its step mode does) against its step mode
    step = tenv.compute_trajectory(ip, iv, DUR, tnet, step_mode=True)[0]
    mod = tenv.compute_trajectory(ip, iv, DUR, tnet, step_mode=False)[0]
    np.testing.assert_allclose(step, mod, rtol=2e-4, atol=2e-4)


def test_open_loop_replays_the_expert(setup):
    """accel=: the open loop replays an acceleration sequence in f64 and
    returns no states or graphs; the expert's own accelerations give back
    its stored trajectory."""
    jenv, tenv, ip, iv, *_ = setup
    pos, vel, acc = tenv.compute_optimal_trajectory(ip, iv, DUR, 0.05, 1.0)
    got = tenv.compute_trajectory(ip, iv, DUR, accel=acc)
    want = jenv.compute_trajectory(ip, iv, DUR, accel=acc)
    assert got[3] is None and got[4] is None
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got[0], pos, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got[1], vel, rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="archit or accel"):
        tenv.compute_trajectory(ip, iv, DUR)


def test_windowed_rollout_needs_a_window(setup):
    jenv, tenv, ip, iv, jnet, params, tnet = setup
    with pytest.raises(ValueError, match="needs history_window"):
        tenv.rollout_traj_device(ip, iv, DUR, tnet, step_mode=False,
                                 **ENVS["grid"])
    with pytest.raises(ValueError, match="env_chunk requires ell_degree"):
        tenv.compute_trajectory(ip, iv, DUR, tnet, env_chunk=12)


class _Windowed(torch.nn.Module):
    """A policy without the step interface: only the full-history forward
    and its causal window."""

    def __init__(self, net):
        super().__init__()
        self.net = net
        self.causal_window = net.causal_window

    def split_forward(self, x, S):
        return self.net.split_forward(x, S)

    def forward(self, x, S):
        return self.split_forward(x, S)[0]


def test_device_store_trains_a_windowed_policy(tmp_path):
    """TrainerFlocking's device store with a policy that has no step
    interface: its re-rolls and validation take the windowed re-forward
    over the causal window, and train as the same weights in step mode do
    (losses and validation costs within 1e-4)."""
    from graph_neural_networks_torch import training as TT
    data = tF.Flocking.large_device(32, 2.0, 1.0, 2, 1, 1, 0.3, 0.1, 16,
                                    rng=np.random.default_rng(0),
                                    device="cpu")
    outs = []
    for wrap in (False, True):
        net = tarcht.LocalGNN_DB([6, 8], [3], True, "tanh", [2], 1,
                                 device="cpu",
                                 generator=torch.Generator().manual_seed(2))
        model = TT.Model(_Windowed(net) if wrap else net, TT.losses.mse_loss,
                         {"name": "ADAM", "lr": 5e-3}, TT.TrainerFlocking,
                         TT.evaluate_flocking, name=f"w{wrap}",
                         saveDir=str(tmp_path))
        outs.append(model.train(data, 1, 1, deviceStore=True, ellDegree=16,
                                probExpert=0.5, DAGgerType="replaceTimeBatch",
                                validationInterval=2, seed=3,
                                coverageCheck=False))
    for key in ("lossTrain", "costValid"):
        assert np.isfinite(outs[1][key]).all()
        np.testing.assert_allclose(outs[1][key], outs[0][key], **TOL)
