"""PyTorch port, the host-numpy flocking store: the Flocking(...) dataset
(the expert, the graphs, the states), the all-pairs closed loop, the dense
recompute, Flocking.large(env_grid=True), the expert relabel,
evaluate_flocking and the two examples, held against the JAX package on the
CPU with the same inputs and weights. TrainerFlocking's host store with
every DAGger type and the dense device store are in
tests/test_torch_flocking_host_training.py.

The JAX grid path runs on its XLA window path (the plain reference of its
Pallas kernels). Tolerances: the host f64 generation rtol = atol = 1e-10
(the same numpy operations); f32 paths rtol = 1e-4 and atol = 1e-4 times
the field's largest magnitude (sums in another order; the states' 1/d^4
terms reach thousands); the trainers' losses and parameters after
several Adam steps rtol = atol = 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from graph_neural_networks_torch import training as TT
from graph_neural_networks_torch.data import flocking as tF
from graph_neural_networks_torch.examples import flocking as tflock
from graph_neural_networks_torch.examples import largeswarm as tlarge
from graph_neural_networks_torch.models import architectures_time as tarcht
from graph_neural_networks_torch.ops import ell as tell
from graph_neural_networks_torch.utils.params import load_flax_params
from graph_neural_networks_tpu import training as JT
from graph_neural_networks_tpu.data import base as jbase
from graph_neural_networks_tpu.data import flocking as jF
from graph_neural_networks_tpu.models import architectures_time as jarcht
from graph_neural_networks_tpu.ops import ell as jell


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine: one intra-op thread
    keeps the many small torch ops here from oversubscribing its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HOST = dict(rtol=1e-10, atol=1e-10)
TOL = dict(rtol=1e-4, atol=1e-4)
# the reference-scale store, cut: 12 agents, T = 8
DENSE = dict(nAgents=12, commRadius=2.0, repelDist=1.0, nTrain=8, nValid=2,
             nTest=2, duration=0.8, samplingTime=0.1)
# the grid store: 64 agents, T = 5, ELL width 16
LARGE = dict(commRadius=2.0, repelDist=1.0, nTrain=6, nValid=1, nTest=1,
             duration=0.5, samplingTime=0.1, ell_degree=16, env_grid=True)
N_LARGE = 64
FIELDS = ("initPos", "initVel", "pos", "vel", "accel", "commGraph", "state")


def close(a, b, rtol=1e-4, scale=1e-4):
    """f32 agreement: rtol, and an atol of `scale` times b's largest
    magnitude."""
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=rtol,
                               atol=scale * max(float(np.abs(b).max()), 1.0))


def _dense(seed=3, **kw):
    cfg = dict(DENSE, **kw)
    return (jF.Flocking(rng=np.random.default_rng(seed), **cfg),
            tF.Flocking(rng=np.random.default_rng(seed), device="cpu", **cfg))


def _large(seed=3):
    return (jF.Flocking.large(N_LARGE, rng=np.random.default_rng(seed),
                              **LARGE),
            tF.Flocking.large(N_LARGE, rng=np.random.default_rng(seed),
                              device="cpu", **LARGE))


def _models(tmp_path, dims=(6, 8), taps=(3,), sigma="tanh", lr=5e-3):
    """A JAX Model and a port Model of one LocalGNN_DB with the JAX init's
    weights."""
    jarc = jarcht.LocalGNN_DB(list(dims), list(taps), True, sigma, [2], 1)
    jm = JT.Model(jarc, JT.losses.mse_loss, {"name": "ADAM", "lr": lr},
                  JT.TrainerFlocking, JT.evaluate_flocking, name="flock",
                  saveDir=str(tmp_path / "jax"), N=12, T=3, seed=6)
    tarc = tarcht.LocalGNN_DB(list(dims), list(taps), True, sigma, [2], 1,
                              device="cpu")
    load_flax_params(tarc, jax.tree_util.tree_map(np.asarray,
                                                  unfreeze(jm.params)))
    tm = TT.Model(tarc, TT.losses.mse_loss, {"name": "ADAM", "lr": lr},
                  TT.TrainerFlocking, TT.evaluate_flocking, name="flock",
                  saveDir=str(tmp_path / "torch"))
    return jm, tm


def _same_params(jm, tm):
    leaves = jax.tree_util.tree_map(np.asarray, unfreeze(jm.params))
    for path, (p, transpose) in tm.archit.flax_names().items():
        want = leaves["params"]
        for k in path:
            want = want[k]
        got = p.detach().numpy()
        np.testing.assert_allclose(got.T if transpose else got, want, **TOL)


def _recording(cls, log):
    """cls logging the initial conditions of every DAGger re-roll."""
    class Recording(cls):
        def _rollout_policy(self, init_pos, init_vel, *a, **k):
            log.append(np.asarray(init_pos).copy())
            return super()._rollout_policy(init_pos, init_vel, *a, **k)
    return Recording


@pytest.fixture(scope="module")
def dense():
    return _dense()


@pytest.fixture(scope="module")
def large():
    return _large()


def test_host_expert_graphs_and_states_match_jax():
    """compute_optimal_trajectory, compute_communication_graph (also
    weighted and unnormalized) and compute_states on the same initial
    conditions, and the helpers behind them."""
    jd = jF.Flocking.for_rollout(12, 2.0, 1.0, 0.1,
                                 rng=np.random.default_rng(4))
    td = tF.Flocking.for_rollout(12, 2.0, 1.0, 0.1, device="cpu",
                                 rng=np.random.default_rng(4))
    ip, iv = td.compute_initial_positions(12, 3, 2.0, minDist=0.1,
                                          geometry="circular")
    want = jd.compute_optimal_trajectory(ip, iv, 1.0, 0.1, 1.0, accelMax=10.)
    got = td.compute_optimal_trajectory(ip, iv, 1.0, 0.1, 1.0, accelMax=10.)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **HOST)
    pos, vel, accel = got
    assert not accel[:, -1].any() and np.abs(accel).max() <= 10.0
    for kw in ({}, dict(weighted=True), dict(kernelType="distance")):
        for norm in (True, False):
            np.testing.assert_allclose(
                td.compute_communication_graph(pos, 2.0, norm, **kw),
                jd.compute_communication_graph(pos, 2.0, norm, **kw), **HOST)
    S = td.compute_communication_graph(pos, 2.0, True)
    np.testing.assert_allclose(
        td.compute_communication_graph(pos[:, 3], 2.0, True), S[:, 3],
        **HOST)
    np.testing.assert_allclose(td.compute_states(pos, vel, S),
                               jd.compute_states(pos, vel, S), **HOST)
    for u in (pos, pos[:, 2]):
        for a, b in zip(tF.compute_differences(u), jF.compute_differences(u)):
            np.testing.assert_array_equal(a, b)
    x = np.array([0.0, 1e-12, -2.0, 4.0])
    np.testing.assert_array_equal(tF.invert_tensor_ew(x),
                                  jbase.invert_tensor_ew(x))


def test_flocking_init_matches_jax_field_by_field(dense):
    jd, td = dense
    for name in FIELDS:
        for split in ("train", "valid", "test"):
            a, b = td.getData(name, split), jd.getData(name, split)
            assert a.dtype == b.dtype == np.float64, name
            np.testing.assert_allclose(a, b, **HOST)
    for split in ("train", "valid", "test"):
        for a, b in zip(td.getSamples(split), jd.getSamples(split)):
            np.testing.assert_allclose(a, b, **HOST)
    assert td.getData("commGraph", "train").shape == (8, 8, 12, 12)
    assert (td.rollout_ell_degree, td.rollout_lam_method,
            td.rollout_env_grid) == (None, "eig", None)
    np.testing.assert_array_equal(td.getData("pos", "train", [1, 4]),
                                  td.pos["train"][[1, 4]])
    f32 = tF.Flocking(rng=np.random.default_rng(3), device="cpu",
                      dataType=np.float32, **DENSE)
    assert f32.getData("commGraph", "test").dtype == np.float32
    assert f32.getSamples("train")[0].dtype == np.float32


@pytest.mark.parametrize("ell_degree,lam_method", [(None, "eig"),
                                                   (None, "power"),
                                                   (4, "power")])
def test_dense_closed_loop_matches_jax(dense, tmp_path, ell_degree,
                                       lam_method):
    """The all-pairs closed loop through the step interface: every output of
    compute_trajectory against JAX's step-mode loop (dense graphs, or top-D
    ELL ones), the positions against JAX's windowed re-forward (the JAX
    trainer's form), and rollout_cost against the cost of JAX's loop."""
    jd, td = dense
    jm, tm = _models(tmp_path)
    jarc, params = jm.archit, jm.params
    for d in (jd, td):
        d.rollout_ell_degree, d.rollout_lam_method = ell_degree, lam_method
    try:
        ip, iv = td.getData("initPos", "valid"), td.getData("initVel", "valid")
        got = td.compute_trajectory(ip, iv, 0.8, tm.archit)
        want = jd.compute_trajectory(ip, iv, 0.8, archit=jarc, params=params)
        policy = lambda p, xw, Sw: jarc.apply(
            p, jnp.asarray(xw, jnp.float32),
            Sw if isinstance(Sw, jell.EllGso) else jnp.asarray(Sw,
                                                               jnp.float32))
        window = jd.compute_trajectory(ip, iv, 0.8, archit=policy,
                                       params=params,
                                       history_window=jarc.causal_window)
        cost = td.rollout_cost(ip, iv, 0.8, tm.archit)
    finally:
        for d in (jd, td):
            d.rollout_ell_degree, d.rollout_lam_method = None, "eig"
    for a, b in zip(got[:4], want[:4]):
        assert a.dtype == np.float64 and a.shape == b.shape
        close(a, b)
    assert not got[2][:, -1].any()
    if ell_degree is None:
        assert got[4].shape == (2, 8, 12, 12) and got[4].dtype == np.float64
        close(got[4], want[4])
    else:
        np.testing.assert_array_equal(got[4].idx, np.asarray(want[4].idx))
        close(got[4].val, want[4].val)
    close(got[0], window[0])
    np.testing.assert_allclose(
        cost, (jd.evaluate(vel=window[1]), jd.evaluate(vel=window[1][:, -1:])),
        **TOL)
    pos, vel = td.rollout_traj_device(ip, iv, 0.8, tm.archit,
                                      ell_degree=ell_degree,
                                      lam_method=lam_method)
    close(pos.numpy(), got[0])
    close(vel.numpy(), got[1])


def test_ell_topk_matches_jax():
    rng = np.random.default_rng(5)
    S = (rng.random((3, 2, 10, 10)) > 0.6) * rng.random((3, 2, 10, 10))
    S[0, :, :, 4] = 0.0                       # a column with no entry
    S[1, 0, :5, 2] = 1.0                      # ties within a column
    for d in (3, 10):
        got = tell.ell_topk(torch.tensor(S, dtype=torch.float32), d)
        want = jell.ell_topk(jnp.asarray(S, jnp.float32), d)
        np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
        np.testing.assert_array_equal(got.val.numpy(), np.asarray(want.val))


@pytest.mark.parametrize("lam_method", ["eig", "power"])
def test_dense_recompute_supervision_matches_jax(dense, lam_method):
    """recompute_supervision against _jnp_recompute_supervision, and against
    the host store's states, labels and graphs to f32 rounding."""
    jd, td = dense
    pos = td.getData("pos", "train").astype(np.float32)
    vel = td.getData("vel", "train").astype(np.float32)
    x, y, S = tF.recompute_supervision(torch.tensor(pos), torch.tensor(vel),
                                       2.0, 1.0, 10.0, lam_method)
    want = jF._jnp_recompute_supervision(jnp.asarray(pos), jnp.asarray(vel),
                                         2.0, 1.0, 10.0, lam_method)
    for a, b in zip((x, y, S), want):
        close(a.numpy(), b)
    assert not y[:, -1].any()
    close(x.numpy(), td.getData("state", "train"))
    close(y.numpy(), td.getData("accel", "train"))
    close(S.numpy(), td.getData("commGraph", "train"))


def test_flocking_large_env_grid_matches_jax(large):
    """Flocking.large(env_grid=True): the grid expert's generation on the
    cell grid, every field against JAX's, the ELL graphs' idx exactly."""
    jd, td = large
    assert (td.rollout_ell_degree, td.rollout_lam_method) == (16, "power")
    assert td.rollout_env_grid is True
    for name in FIELDS:
        for split in ("train", "valid", "test"):
            a, b = td.getData(name, split), jd.getData(name, split)
            if name == "commGraph":
                assert isinstance(a, tell.EllGso)
                assert a.idx.dtype == np.int32 and a.val.dtype == np.float32
                assert a.val.shape == (len(b.idx), 5, 1, N_LARGE, 16)
                np.testing.assert_array_equal(a.idx, np.asarray(b.idx))
                close(a.val, b.val)
            else:
                assert a.dtype == b.dtype == np.float32, name
                close(a, b)
    assert not td.getData("accel", "train")[:, -1].any()
    x, _ = td.getSamples("train")
    np.testing.assert_array_equal(x, td.getData("state", "train"))


def test_expert_relabel_matches_jax(dense, large, tmp_path):
    """_expert_accel: the dense f64 branch and the grid branch against the
    JAX trainer's, both clipped at the dataset's accelMax, the T-1 label
    kept."""
    for jd, td in (dense, large):
        jm, tm = _models(tmp_path)
        kw = dict(ellDegree=16) if td.rollout_env_grid else {}
        jtr = JT.TrainerFlocking(jm, jd, 1, 2, **kw)
        ttr = TT.TrainerFlocking(tm, td, 1, 2, **kw)
        pos = td.getData("pos", "train").astype(np.float64)
        vel = td.getData("vel", "train").astype(np.float64) * 1e-2
        got = ttr._expert_accel(pos, vel)
        want = np.asarray(jtr._expert_accel(pos, vel))
        assert got.dtype == np.float64 and got.shape == pos.shape
        assert np.abs(got).max() <= td.accelMax and got[:, -1].any()
        if td.rollout_env_grid:
            close(got, want)
        else:
            np.testing.assert_allclose(got, want, **HOST)


def test_evaluate_flocking_matches_jax(tmp_path):
    """evaluate_flocking on the host store's test split after training, and
    on the ELL store's."""
    for jd, td in (_dense(), _large()):
        jm, tm = _models(tmp_path / str(td.nAgents))
        kw = dict(validationInterval=2, seed=6)
        if td.rollout_env_grid:
            kw["ellDegree"] = 16
        jm.train(jd, 1, 3, **kw)
        tm.train(td, 1, 3, **kw)
        want = JT.evaluate_flocking(jm, jd)
        got = TT.evaluate_flocking(tm, td)
        assert sorted(got) == sorted(want) == [
            "costBestEnd", "costBestFull", "costLastEnd", "costLastFull"]
        for k in want:
            np.testing.assert_allclose(got[k], want[k], **TOL)


def test_local_flt_identity_takes_jax_weights(dense, tmp_path):
    """LocalFlt's identity nonlinearity: the JAX weights load and the
    forward and the closed loop agree."""
    jd, td = dense
    jm, tm = _models(tmp_path, dims=(6, 2), sigma="identity")
    x, _ = td.getSamples("valid")
    S = td.getData("commGraph", "valid")
    close(tm.archit(torch.tensor(x, dtype=torch.float32),
                    torch.tensor(S, dtype=torch.float32)).detach().numpy(),
          jm.archit.apply(jm.params, jnp.asarray(x, jnp.float32),
                          jnp.asarray(S, jnp.float32)))
    ip, iv = td.getData("initPos", "test"), td.getData("initVel", "test")
    close(td.compute_trajectory(ip, iv, 0.8, tm.archit)[1],
          jd.compute_trajectory(ip, iv, 0.8, archit=jm.archit,
                                params=jm.params)[1])


def test_flocking_driver_quick_on_the_cpu():
    out = tflock.main(["--quick", "--device", "cpu"])
    assert out["device"] == "cpu" and out["n_agents"] == 12
    assert sorted(out["models"]) == ["GraphRNN", "LocalGNN"]
    for name, res in out["models"].items():
        for k in ("costBestFull", "costBestEnd", "loss_first", "loss_last",
                  "best_valid"):
            assert np.isfinite(res[k]), (name, k)
    assert np.isfinite(out["expert"])


@pytest.mark.parametrize("mode", [[], ["--largeTrain"]])
def test_largeswarm_driver_modes_on_the_cpu(mode):
    out = tlarge.main(["--device", "cpu", "--quick", "--nEpochs", "2",
                       "--nTrain", "8", "--ellDegree", "16",
                       "--deployAgents", "128", "--duration", "0.3"] + mode)
    assert out["mode"] == ("Flocking.large" if mode else "Flocking")
    assert out["train_agents"] == 12 and out["deploy_agents"] == 128
    for k in ("loss_first", "loss_last", "best_valid", "cost_small",
              "expert", "cost_big"):
        assert np.isfinite(out[k]), k
