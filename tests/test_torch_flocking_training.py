"""PyTorch port, the flocking training slice: the expert's repel pass, the
grid and all-pairs experts, the training-batch recompute,
Flocking.large_device, TrainerFlocking over the device-resident store
and evaluate_flocking, held against the JAX package on the CPU with the
same inputs and weights. DAGger over that store, the re-rolls' lam_iters
and the largeswarm example are in tests/test_torch_flocking_dagger.py.

The JAX grid path runs on its XLA window path and, where a test covers
the kernel, on the Pallas kernel in interpret mode. Tolerance: rtol =
atol = 1e-4 unless stated (f32 sums in another order; the trainers' losses
and parameters after several Adam steps).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from graph_neural_networks_torch import training as TT
from graph_neural_networks_torch.data import flocking as tF
from graph_neural_networks_torch.models import architectures_time as tarcht
from graph_neural_networks_torch.ops import ell as tell
from graph_neural_networks_torch.utils.params import load_flax_params
from graph_neural_networks_tpu import training as JT
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


TOL = dict(rtol=1e-4, atol=1e-4)
# the training store: 32 agents at the flocking radii, T = 5
STORE = dict(commRadius=2.0, repelDist=1.0, nTrain=6, nValid=2, nTest=2,
             duration=0.5, samplingTime=0.1, ell_degree=16)
N_STORE = 32


def _t(a):
    return torch.tensor(np.asarray(a))


def _swarm(N, B, seed):
    env = tF.Flocking.for_rollout(N, 2.0, 1.0, 0.01, device="cpu",
                                  rng=np.random.default_rng(seed))
    ip, iv = env.compute_initial_positions(N, B, 2.0, minDist=0.1,
                                           geometry="circular")
    return ip.astype(np.float32), iv.astype(np.float32)


def _port_store(jd, seed):
    """The port's large_device dataset from the same rng, its (pos, vel)
    then replaced by the JAX store's (the trainers start from one
    store)."""
    td = tF.Flocking.large_device(N_STORE, rng=np.random.default_rng(seed),
                                  device="cpu", **STORE)
    for split in ("train", "valid", "test"):
        td.pos[split] = _t(jd.pos[split])
        td.vel[split] = _t(jd.vel[split])
    return td


def _models(tmp_path, seed=6):
    """A JAX Model and a port Model of LocalGNN_DB([6, 8], [2]) with the
    JAX init's weights."""
    jarc = jarcht.LocalGNN_DB([6, 8], [2], True, "tanh", [2], 1)
    jm = JT.Model(jarc, JT.losses.mse_loss, {"name": "ADAM", "lr": 5e-4},
                  JT.TrainerFlocking, JT.evaluate_flocking, name="flock",
                  saveDir=str(tmp_path / "jax"), N=16, T=5, seed=seed)
    tarc = tarcht.LocalGNN_DB([6, 8], [2], True, "tanh", [2], 1,
                              device="cpu")
    load_flax_params(tarc, jax.tree_util.tree_map(np.asarray,
                                                  unfreeze(jm.params)))
    tm = TT.Model(tarc, TT.losses.mse_loss, {"name": "ADAM", "lr": 5e-4},
                  TT.TrainerFlocking, TT.evaluate_flocking, name="flock",
                  saveDir=str(tmp_path / "torch"))
    return jm, tm


@pytest.fixture(scope="module")
def stores():
    jd = jF.Flocking.large_device(N_STORE, rng=np.random.default_rng(40),
                                  **STORE)
    td = tF.Flocking.large_device(N_STORE, rng=np.random.default_rng(40),
                                  device="cpu", **STORE)
    return jd, td


@pytest.fixture(scope="module")
def trained(stores, tmp_path_factory):
    """Both packages trained from one store and one init, no DAGger."""
    jd, _ = stores
    td = _port_store(jd, 40)
    jm, tm = _models(tmp_path_factory.mktemp("trained"))
    kw = dict(validationInterval=2, deviceStore=True, ellDegree=16, seed=6)
    jout = jm.train(jd, 2, 2, **kw)
    tout = tm.train(td, 2, 2, **kw)
    return jd, td, jm, tm, jout, tout


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("P,lam_iters", [(0, 1), (12, 0)])
def test_env_step_grid_expert_repel_matches_jax(use_kernel, P, lam_iters):
    """The repel pass's collision sums (and the step's other outputs)
    against _jnp_env_step_grid(expert_repel=) on its XLA window path and
    on the Pallas kernel in interpret mode."""
    ip, iv = _swarm(256, 2, 41)
    rng = np.random.default_rng(P)
    v0 = np.abs(rng.normal(size=(2, 256))).astype(np.float32)
    pay = rng.normal(size=(2, 256, P)).astype(np.float32) if P else None
    kw = dict(lam_iters=lam_iters, cell_cap=32, cell_factor=2,
              expert_repel=1.0)
    got = tF.env_step_grid(_t(ip), _t(iv), 2.0, 16, _t(v0),
                           payload=None if pay is None else _t(pay), **kw)
    want = jF._jnp_env_step_grid(
        jnp.asarray(ip), jnp.asarray(iv), 2.0, 16, jnp.asarray(v0),
        use_kernel=use_kernel,
        payload=None if pay is None else jnp.asarray(pay), **kw)
    assert len(got) == len(want) == (7 if P else 6)
    assert bool(got[-1]) and bool(want[-1])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for a, b in zip(got[1:-1], want[1:-1]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert float(got[-2].abs().max()) > 0        # some pair within repel


def test_expert_repel_runs_before_the_lambda_passes():
    """The repel pass reads the table before any lambda pass rewrites its
    v lanes: its sums do not depend on lam_iters, and they are the grid
    expert's."""
    ip, iv = _swarm(200, 2, 42)
    v0 = torch.rand(2, 200, generator=torch.Generator().manual_seed(0))
    reps = [tF.env_step_grid(_t(ip), _t(iv), 2.0, 8, v0, lam_iters=k,
                             cell_cap=32, cell_factor=2,
                             expert_repel=1.0)[4] for k in (0, 1, 5)]
    for r in reps[1:]:
        assert torch.equal(r, reps[0])
    a, ok = tF.expert_accel_grid(_t(ip), _t(iv), 2.0, 1.0, 1e9)
    assert bool(ok)
    np.testing.assert_allclose(
        a.numpy(), (tF._velocity_term(_t(iv)) + reps[0]).numpy(), **TOL)


def test_expert_accel_grid_matches_jax_and_all_pairs():
    """Grid expert against JAX's and against the plain all-pairs expert;
    the all-pairs expert against JAX's chunked one. Unclipped (the clip
    would hide the collision sums); a random swarm has no d^2 = 1 pair."""
    ip, iv = _swarm(300, 2, 43)
    pos, vel = _t(ip), _t(iv)
    grid, ok = tF.expert_accel_grid(pos, vel, 2.0, 1.0, 1e9)
    jgrid, jok = jF._jnp_expert_accel_grid(jnp.asarray(ip), jnp.asarray(iv),
                                           2.0, 1.0, 1e9, use_kernel=False)
    assert bool(ok) and bool(jok)
    np.testing.assert_allclose(grid.numpy(), np.asarray(jgrid), **TOL)
    plain = tF.expert_accel(pos, vel, 1.0, 1e9)
    jplain = jF._jnp_expert_accel_chunked(jnp.asarray(ip), jnp.asarray(iv),
                                          1.0, 1e9, 300)
    np.testing.assert_allclose(plain.numpy(), np.asarray(jplain), **TOL)
    np.testing.assert_allclose(grid.numpy(), plain.numpy(), **TOL)
    # clipped as the labels are
    np.testing.assert_allclose(
        tF.expert_accel_grid(pos, vel, 2.0, 1.0, 100.0)[0].numpy(),
        torch.clamp(plain, -100.0, 100.0).numpy(), **TOL)


def test_repel_boundary_pairs_follow_each_comparator():
    """Two pairs at exactly d^2 = repel^2: the window pass counts them (<=,
    as the JAX grid expert), the all-pairs expert does not (<, as JAX's)."""
    pos = np.array([[[0.0, 1.0, 0.0, 0.0, 6.0, 9.0],
                     [0.0, 0.0, 5.0, 6.0, 6.0, 9.0]]], np.float32)
    vel = np.zeros_like(pos)
    grid, _ = tF.expert_accel_grid(_t(pos), _t(vel), 2.0, 1.0, 1e9)
    jgrid, _ = jF._jnp_expert_accel_grid(jnp.asarray(pos), jnp.asarray(vel),
                                         2.0, 1.0, 1e9, use_kernel=False)
    np.testing.assert_allclose(grid.numpy(), np.asarray(jgrid), **TOL)
    # 2 * dp * (inv^2 + inv) with d^2 = 1: -4 and +4 along the pair's axis
    np.testing.assert_allclose(grid[0, 0, :2].numpy(), [-4.0, 4.0])
    np.testing.assert_allclose(grid[0, 1, 2:4].numpy(), [-4.0, 4.0])
    plain = tF.expert_accel(_t(pos), _t(vel), 1.0, 1e9)
    jplain = jF._jnp_expert_accel_chunked(jnp.asarray(pos), jnp.asarray(vel),
                                          1.0, 1e9, 6)
    np.testing.assert_array_equal(plain.numpy(), np.zeros_like(pos))
    np.testing.assert_array_equal(np.asarray(jplain), np.zeros_like(pos))


def test_large_device_matches_jax(stores):
    jd, td = stores
    assert td.generation_ok
    assert td.rollout_lam_iters == 1 and td.rollout_ell_degree == 16
    for split, n in (("train", 6), ("valid", 2), ("test", 2)):
        np.testing.assert_array_equal(td.initPos[split], jd.initPos[split])
        np.testing.assert_array_equal(td.initVel[split], jd.initVel[split])
        assert tuple(td.pos[split].shape) == (n, 5, 2, N_STORE)
        np.testing.assert_allclose(td.pos[split].numpy(),
                                   np.asarray(jd.pos[split]), **TOL)
        np.testing.assert_allclose(td.vel[split].numpy(),
                                   np.asarray(jd.vel[split]), **TOL)
    sel = td.getData("pos", "train", [1, 3])
    assert torch.equal(sel, td.pos["train"][[1, 3]])


def test_large_device_ragged_gen_batch_matches_one_at_a_time():
    kw = dict(STORE, nTrain=3, nValid=1, nTest=1)
    one = tF.Flocking.large_device(N_STORE, rng=np.random.default_rng(44),
                                   device="cpu", **kw)
    three = tF.Flocking.large_device(N_STORE, rng=np.random.default_rng(44),
                                     device="cpu", gen_batch=3, **kw)
    for split in ("train", "valid", "test"):
        np.testing.assert_allclose(three.pos[split].numpy(),
                                   one.pos[split].numpy(), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("lam_iters", [1, 3])
def test_recompute_supervision_grid_matches_jax(stores, lam_iters):
    """States, labels, the ELL graphs (as dense stacks) and ok against
    _jnp_recompute_supervision_grid on the JAX store."""
    jd, _ = stores
    pos, vel = jd.pos["train"], jd.vel["train"]
    want = jF._jnp_recompute_supervision_grid(pos, vel, 2.0, 1.0, 100.0, 16,
                                              True, lam_iters=lam_iters)
    x, y, ell, ok, deg = tF.recompute_supervision_grid(
        _t(pos), _t(vel), 2.0, 1.0, 100.0, 16, True, lam_iters=lam_iters)
    assert bool(ok) == bool(want[3]) and bool(ok)
    assert 0 < int(deg) <= 16
    np.testing.assert_allclose(x.numpy(), np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(want[1]), **TOL)
    assert not y[:, -1].any()
    np.testing.assert_array_equal(ell.idx.numpy(), np.asarray(want[2][0]))
    np.testing.assert_allclose(
        tell.ell_to_dense(ell),
        jell.ell_to_dense(jell.EllGso(*want[2])), **TOL)


def test_trainer_flocking_device_store_matches_jax(trained):
    """TrainerFlocking(deviceStore=True) from JAX's store and JAX's initial
    params, no DAGger: per-step losses, validation costs and the final
    (Best) params against the JAX trainer's."""
    _, _, jm, tm, jout, tout = trained
    assert len(tout["lossTrain"]) == 6
    np.testing.assert_allclose(tout["lossTrain"], jout["lossTrain"], **TOL)
    np.testing.assert_allclose(tout["costValid"], jout["costValid"], **TOL)
    assert (tout["bestEpoch"], tout["bestBatch"]) == (
        jout["bestEpoch"], jout["bestBatch"])
    names = tm.archit.flax_names()
    leaves = jax.tree_util.tree_map(np.asarray, unfreeze(jm.params))
    for path, (p, transpose) in names.items():
        want = leaves["params"]
        for k in path:
            want = want[k]
        got = p.detach().numpy()
        np.testing.assert_allclose(got.T if transpose else got, want, **TOL)


def test_evaluate_flocking_matches_jax(trained):
    jd, td, jm, tm, _, _ = trained
    want = JT.evaluate_flocking(jm, jd)
    got = TT.evaluate_flocking(tm, td)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL)


def test_coverage_check_warns_where_jax_does_not(stores, tmp_path):
    """In-degrees above ellDegree with no payload on the table: the port's
    coverage check reads the window pass's count and warns; the JAX check
    (ok covers cell overflow only) does not."""
    jd, _ = stores
    td = _port_store(jd, 40)
    jm, tm = _models(tmp_path)
    kw = dict(deviceStore=True, ellDegree=2, seed=6)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        JT.TrainerFlocking(jm, jd, 1, 2, **kw)
    assert not [w for w in caught if "ellDegree" in str(w.message)]
    with pytest.warns(RuntimeWarning, match="in-degree above ellDegree"):
        tr = TT.TrainerFlocking(tm, td, 1, 2, **kw)
    assert tr.maxInDegree > 2
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        TT.TrainerFlocking(tm, td, 1, 2, deviceStore=True, ellDegree=16)


def test_host_store_raises_naming_7_1b(stores, tmp_path):
    """The host store is ported (the name is kept from when it raised), and
    so are the two paths that raised here naming item 7.3, now against
    JAX: the chunked all-pairs env (Flocking.large without env_grid) and
    the chunked expert relabel (a dataset with rollout_env_chunk and no
    grid). What still raises: a device store with fixedBatch, with the
    JAX trainer's message."""
    jd, td = stores
    jm, tm = _models(tmp_path)
    kw = dict(STORE, env_grid=None, nTrain=1, nValid=0, nTest=0)
    got = tF.Flocking.large(32, device="cpu", rng=np.random.default_rng(3),
                            **kw)
    want = jF.Flocking.large(32, rng=np.random.default_rng(3), **kw)
    np.testing.assert_array_equal(got.getData("commGraph", "train").idx,
                                  np.asarray(want.getData("commGraph",
                                                          "train").idx))
    np.testing.assert_allclose(got.getData("accel", "train"),
                               want.getData("accel", "train"), rtol=1e-4,
                               atol=1e-4)
    trainer = TT.TrainerFlocking(tm, td, 1, 2, ellDegree=16,
                                 deviceStore=True, coverageCheck=False)
    td.rollout_env_grid, td.rollout_env_chunk = None, 8
    try:
        trainer.grid = None
        rng = np.random.default_rng(5)
        pos = rng.normal(size=(1, 2, 2, 16)) * 2
        vel = rng.normal(size=(1, 2, 2, 16))
        a = trainer._expert_accel(pos, vel)
        np.testing.assert_allclose(
            a, np.asarray(jF._jnp_expert_accel_chunked(
                jnp.asarray(pos.reshape(2, 2, 16), jnp.float32),
                jnp.asarray(vel.reshape(2, 2, 16), jnp.float32), td.repelDist,
                td.accelMax, 8)).reshape(a.shape), rtol=1e-4, atol=1e-4)
    finally:
        td.rollout_env_grid, td.rollout_env_chunk = True, None
    msg = "fixedBatch rolls out per batch on host"
    kw = dict(deviceStore=True, ellDegree=16, probExpert=0.5,
              DAGgerType="fixedBatch")
    with pytest.raises(AssertionError, match=msg):
        JT.TrainerFlocking(jm, jd, 1, 2, **kw)
    with pytest.raises(ValueError, match=msg):
        TT.TrainerFlocking(tm, td, 1, 2, **kw)
