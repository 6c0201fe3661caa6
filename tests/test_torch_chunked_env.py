"""PyTorch port, data/flocking.py's chunked all-pairs environment: the
first-d_max extractor (_env_topk), the blocked exact top-k, the chunked
env step and expert, and Flocking.large without env_grid, held against
the JAX package on the CPU with the same inputs, and against the port's
dense and grid steps.

TrainerFlocking over that store: the chunked expert relabel as the JAX
trainer computes it and against the f64 host expert (rtol 1e-4 plus 1e-5
of the largest label), and a training run with DAGger re-rolls and
validation on the chunked env.

Exact: _env_topk and _topk_blocked (bit for bit), selected neighbor ids,
_fit_chunk, the initial conditions. A single env step's states and values
at rtol 1e-5 plus 1e-5 of the channel's largest value (sums in another
order: the port contracts the offsets with inv and inv^2 in one dot
product and takes the velocity sum as v_i·deg_i - (M v)_i); the generated
trajectories at rtol 1e-4 plus 1e-4 of the field's largest value, as the
JAX package's own chunked tests hold them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_neural_networks_torch import training as TT
from graph_neural_networks_torch.data import flocking as tF
from graph_neural_networks_torch.models import architectures_time as tarcht
from graph_neural_networks_torch.ops import ell as tell
from graph_neural_networks_tpu.data import flocking as jF
from graph_neural_networks_tpu.ops import ell as jell

from tests.test_torch_flocking import _close


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine: one intra-op thread
    keeps the many small torch ops here from oversubscribing its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


STEP = dict(rtol=1e-5, atol_rel=1e-5)
LARGE = dict(commRadius=2.0, repelDist=1.0, nTrain=3, nValid=1, nTest=1,
             duration=0.5, samplingTime=0.1, ell_degree=16, env_chunk=16,
             lam_iters=8)
N_LARGE = 48


def _t(a):
    return torch.tensor(np.asarray(a))


# the JAX side jitted: eagerly it compiles op by op, ~1 s a call
_j_env_topk = jax.jit(jF._env_topk, static_argnums=1)
_j_topk_blocked = jax.jit(jF._topk_blocked, static_argnums=(1, 2))
_j_env_step = jax.jit(jF._jnp_env_step_chunked, static_argnums=(2, 3, 4, 6))
_j_expert = jax.jit(jF._jnp_expert_accel_chunked, static_argnums=(2, 3, 4))


def _rand_swarm(N=60, B=2, seed=5):
    """JAX tests/test_ell.py's swarm: circular, commRadius 2, f32."""
    env = tF.Flocking.for_rollout(N, 2.0, 1.0, 0.05, device="cpu",
                                  rng=np.random.default_rng(seed))
    ip, iv = env.compute_initial_positions(N, B, 2.0, minDist=0.1,
                                           geometry="circular")
    return ip.astype(np.float32), iv.astype(np.float32)


def _dense_ell(idx, val):
    """(B,N,N) dense matrices of (B,N,D) ELL rows (slot order dropped)."""
    B, N, _ = idx.shape
    S = np.zeros((B, N, N))
    for b in range(B):
        np.add.at(S[b], (np.arange(N)[:, None].repeat(idx.shape[-1], 1),
                         np.asarray(idx[b])), np.asarray(val[b]))
    return S


@pytest.mark.parametrize("D", [1, 8, 120])
def test_env_topk_bit_equal_to_jax(D):
    """Bit for bit on random binary masks whose rows have densities 0,
    0.02, 0.1, 0.6 and 1 (rows with no, fewer than D and more than D set
    bits), D above the row length too; a bool mask gives the same."""
    rng = np.random.default_rng(7)
    dens = np.array([0.0, 0.02, 0.1, 0.6, 1.0])[:, None]
    mf = (rng.random((2, 5, 97)) < dens).astype(np.float32)
    v1, i1 = _j_env_topk(jnp.asarray(mf), D)
    v2, i2 = tF._env_topk(_t(mf), D)
    assert i2.dtype == torch.int32 and v2.dtype == torch.float32
    np.testing.assert_array_equal(v2.numpy(), np.asarray(v1))
    np.testing.assert_array_equal(i2.numpy(), np.asarray(i1))
    v3, i3 = tF._env_topk(_t(mf) > 0, D)
    assert torch.equal(v3, v2) and torch.equal(i3, i2)


@pytest.mark.parametrize("binary", [True, False])
def test_topk_blocked_bit_equal_to_jax(binary):
    """Values and indices equal to the JAX two-stage top-k, ties among
    binary and quantized scores included (stable sorts: index order)."""
    rng = np.random.default_rng(13)
    s = rng.random((3, 4, 64)).astype(np.float32)
    s = (s < 0.1).astype(np.float32) if binary else np.round(s * 4) / 4
    v1, i1 = _j_topk_blocked(jnp.asarray(s), 6, 16)
    v2, i2 = tF._topk_blocked(_t(s), 6, 16)
    np.testing.assert_array_equal(v2.numpy(), np.asarray(v1))
    np.testing.assert_array_equal(i2.numpy(), np.asarray(i1))


def test_fit_chunk_matches_jax():
    for n, c in ((60, 30), (60, 7), (97, 8), (12, 100), (4096, 512), (5, 0)):
        assert tF._fit_chunk(n, c) == jF._fit_chunk(n, c)


@pytest.mark.parametrize("N,D,chunk,lam_iters", [(12, 12, 4, 64),
                                                 (60, 32, 30, 8),
                                                 (60, 4, 12, 3)])
def test_env_step_chunked_matches_jax(N, D, chunk, lam_iters):
    """One chunked step against JAX's: ids exactly, values, states and the
    eigenvector; D = 4 cuts rows (lambda is then the truncated graph's,
    on both sides)."""
    rng = np.random.default_rng(3)
    pos = (rng.standard_normal((2, 2, N)) * 2).astype(np.float32)
    vel = rng.standard_normal((2, 2, N)).astype(np.float32)
    v0 = np.full((2, N), 1 / np.sqrt(N), np.float32)
    want = _j_env_step(jnp.asarray(pos), jnp.asarray(vel), 2.0, D, chunk,
                       jnp.asarray(v0), lam_iters)
    got = tF.env_step_chunked(_t(pos), _t(vel), 2.0, D, chunk, _t(v0),
                              lam_iters=lam_iters)
    assert got[0].dtype == torch.int32 and got[0].shape == (2, N, D)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    _close(got[1].numpy(), want[1], **STEP)
    _close(got[2].numpy(), want[2], axis=1, **STEP)
    _close(got[3].numpy(), want[3], **STEP)
    with pytest.raises(ValueError, match="does not divide"):
        tF.env_step_chunked(_t(pos), _t(vel), 2.0, D, 7, _t(v0))


def test_env_step_chunked_matches_dense_and_grid_steps():
    """Against the port's dense step (d_max covers the in-degree: the same
    graph, states and lambda) and its grid step (the same neighbor sets,
    states and values; the grid lists a row by window, so as matrices)."""
    ip, iv = _rand_swarm()
    pos, vel = _t(ip), _t(iv)
    B, _, N = pos.shape
    v0 = torch.full((B, N), 1 / np.sqrt(N))
    idx, val, x, _ = tF.env_step_chunked(pos, vel, 2.0, 32, 30, v0,
                                         lam_iters=64)
    S = tF.comm_graph(pos, 2.0, "power")
    _close(_dense_ell(idx, val), S.numpy().transpose(0, 2, 1), **STEP)
    _close(x.numpy(), tF.states(pos, vel, S).numpy(), axis=1, **STEP)
    ig, sg, xg, _, ok = tF.env_step_grid(pos, vel, 2.0, 32, v0,
                                         lam_iters=64, cell_cap=64)
    assert bool(ok)
    np.testing.assert_array_equal(_dense_ell(ig, sg) > 0,
                                  _dense_ell(idx, val) > 0)
    _close(_dense_ell(ig, sg), _dense_ell(idx, val), **STEP)
    _close(xg.numpy(), x.numpy(), axis=1, **STEP)


def test_expert_accel_chunked_matches_jax_dense_and_grid():
    """Against JAX's chunked expert, the port's one-chunk dense expert and
    its grid expert (the d2 = repel^2 comparator aside, which this swarm
    does not hit)."""
    ip, iv = _rand_swarm()
    for chunk in (60, 12, 5):
        got = tF.expert_accel_chunked(_t(ip), _t(iv), 1.0, 10.0, chunk)
        want = _j_expert(jnp.asarray(ip), jnp.asarray(iv), 1.0, 10.0, chunk)
        _close(got.numpy(), want, **STEP)
    _close(got.numpy(), tF.expert_accel(_t(ip), _t(iv), 1.0, 10.0).numpy(),
           **STEP)
    grid, ok = tF.expert_accel_grid(_t(ip), _t(iv), 2.0, 1.0, 10.0,
                                    table_size=256, cell_cap=60)
    assert bool(ok)
    _close(grid.numpy(), got.numpy(), **STEP)


def test_generate_trajectories_large_chunked_matches_jax():
    """The chunked generation (no env_grid: a 5-tuple, no ok flag) against
    JAX's from the same initial conditions, and against the port's grid
    generation at ell_degree = N (the same neighbor sets)."""
    ip, iv = _rand_swarm(N=48)
    jenv = jF.Flocking.for_rollout(48, 2.0, 1.0, 0.1)
    tenv = tF.Flocking.for_rollout(48, 2.0, 1.0, 0.1, device="cpu")
    want = jenv.generate_trajectories_large(ip, iv, 0.4, ell_degree=48,
                                            env_chunk=12, lam_iters=64)
    got = tenv.generate_trajectories_large(ip, iv, 0.4, ell_degree=48,
                                           env_chunk=12, lam_iters=64)
    assert len(got) == len(want) == 5
    for a, b in zip(got[:4], want[:4]):
        assert a.dtype == np.float32
        _close(a, b, rtol=1e-4, atol_rel=1e-4)
    np.testing.assert_array_equal(got[4].idx, np.asarray(want[4].idx))
    _close(got[4].val, want[4].val, rtol=1e-4, atol_rel=1e-4)
    assert not got[2][:, -1].any()
    grid = tenv.generate_trajectories_large(ip, iv, 0.4, ell_degree=48,
                                            env_chunk=12, lam_iters=64,
                                            env_grid=(256, 48))
    assert len(grid) == 6 and grid[5] is True
    for a, b in zip(grid[:4], got[:4]):
        _close(a, b, rtol=1e-4, atol_rel=1e-4)
    dense = lambda g: tell.ell_to_dense(g)[:, :, 0]
    _close(dense(grid[4]), dense(got[4]), rtol=1e-4, atol_rel=1e-4)


@pytest.fixture(scope="module")
def large():
    """Flocking.large without env_grid, the port's and JAX's, one seed."""
    return (jF.Flocking.large(N_LARGE, rng=np.random.default_rng(4), **LARGE),
            tF.Flocking.large(N_LARGE, rng=np.random.default_rng(4),
                              device="cpu", **LARGE))


def test_flocking_large_chunked_matches_jax(large):
    """Every field of every split against JAX's, the rollout defaults (the
    chunk fitted to divide N and set whether or not a grid is given)."""
    jd, td = large
    assert td.rollout_env_chunk == jd.rollout_env_chunk == 16
    assert td.rollout_env_grid is None
    assert (td.rollout_ell_degree, td.rollout_lam_method) == (16, "power")
    for name in ("initPos", "initVel", "pos", "vel", "accel", "commGraph",
                 "state"):
        for split in ("train", "valid", "test"):
            a, b = td.getData(name, split), jd.getData(name, split)
            if name == "commGraph":
                assert isinstance(a, tell.EllGso)
                np.testing.assert_array_equal(a.idx, np.asarray(b.idx))
                a, b = a.val, b.val
            assert a.dtype == np.float32, name
            _close(a, b, rtol=1e-4, atol_rel=1e-4)
    d = tF.Flocking.large(N_LARGE, rng=np.random.default_rng(4),
                          device="cpu", **dict(LARGE, nTrain=1, nValid=0,
                                               nTest=0, env_chunk=None,
                                               env_grid=True))
    assert d.rollout_env_chunk == jF._fit_chunk(N_LARGE, N_LARGE // 8)
    assert d.rollout_env_grid is True
    jS = jell.ell_to_dense(jd.getData("commGraph", "test"))
    np.testing.assert_allclose(tell.ell_to_dense(td.getData("commGraph",
                                                            "test")),
                               jS, rtol=1e-4, atol=1e-4)


def _port_model(tmp_path):
    net = tarcht.LocalGNN_DB([6, 8], [3], True, "tanh", [2], 1, device="cpu",
                             generator=torch.Generator().manual_seed(6))
    return TT.Model(net, TT.losses.mse_loss, {"name": "ADAM", "lr": 5e-3},
                    TT.TrainerFlocking, TT.evaluate_flocking, name="flock",
                    saveDir=str(tmp_path))


def test_chunked_relabel_matches_jax_and_the_host_expert(large, tmp_path):
    """TrainerFlocking._expert_accel on a chunked store: the chunked expert
    in f32 on the device, as the JAX trainer's (the chunked expert at the
    dataset's fitted chunk, bit for bit), and against the f64 host expert,
    clipped at accelMax, the T-1 label kept."""
    jd, td = large
    ttr = TT.TrainerFlocking(_port_model(tmp_path), td, 1, 2, ellDegree=16)
    pos = td.getData("pos", "train").astype(np.float64)
    vel = td.getData("vel", "train").astype(np.float64) * 1e-2
    got = ttr._expert_accel(pos, vel)
    assert got.dtype == np.float64 and got.shape == pos.shape
    assert np.abs(got).max() <= td.accelMax and got[:, -1].any()
    # the JAX trainer's relabel is its chunked expert over the B*T steps
    # at the fitted chunk, which the port's matches (test above)
    B, T, _, N = pos.shape
    flat = lambda a: torch.tensor(a.reshape(B * T, 2, N), dtype=torch.float32)
    want = tF.expert_accel_chunked(flat(pos), flat(vel), td.repelDist,
                                   td.accelMax,
                                   jF._fit_chunk(N, jd.rollout_env_chunk))
    np.testing.assert_array_equal(got, want.numpy().reshape(pos.shape))
    _close(got, tF.expert_accel_host(pos, vel, td.repelDist, td.accelMax),
           rtol=1e-4, atol_rel=1e-5)


def test_trainer_on_a_chunked_store(large, tmp_path):
    """TrainerFlocking over Flocking.large(env_grid=None) (JAX
    tests/test_ell.py:282): finite losses, its validation on the chunked
    env, and evaluate_flocking's cost equal to the chunked rollout's of the
    same weights. The step is the ELL host store's, held against JAX in
    tests/test_torch_flocking_host_training.py; the rollouts against JAX
    in tests/test_torch_rollout_modes.py; the relabel above."""
    _, td = large
    tm = _port_model(tmp_path)
    out = tm.train(td, 1, 2, validationInterval=1, seed=6, ellDegree=16,
                   probExpert=0.5, DAGgerType="replaceTimeBatch")
    assert len(out["lossTrain"]) == len(out["costValid"]) == 2
    assert np.isfinite(out["lossTrain"]).all()
    assert np.isfinite(out["costValid"]).all()
    got = TT.evaluate_flocking(tm, td)               # leaves Last loaded
    vel = td.compute_trajectory(td.getData("initPos", "test"),
                                td.getData("initVel", "test"), td.duration,
                                tm.archit)[1]
    np.testing.assert_allclose(got["costLastFull"], td.evaluate(vel=vel),
                               rtol=1e-12)
