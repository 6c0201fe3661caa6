"""PyTorch port, the time-varying recurrent and aggregation controllers:
grnn_db (dense and ELL), HiddenStateDB, GraphRecurrentNN_DB and
AggregationGNN_DB (split_forward, the step interface), the unfused and
fused grid rollouts, a TrainerFlocking step of each model over the host
and the device store, and evaluate_flocking, held against the JAX package
on the CPU with the same weights (carried across by load_flax_params).

z0 is passed explicitly on both sides, since the two packages' random
streams differ by design: the port's rollouts get JAX's
``jax.random.normal(PRNGKey(0), (B, H, N))`` through a test-side
``rollout_init``, and a trainer's forward a fixed z0 likewise.

Tolerances: atol = rtol = 1e-4 for functions, gradients, losses and
parameters after a step (f32 sums in another order, fed back through T
recurrence steps); closed-loop rollouts as tests/test_torch_flocking.py
holds them (positions and velocities rtol = atol = 1e-5 over T steps;
accelerations and states rtol 1e-4 with an absolute term of 1e-5 of the
channel's largest value).
"""

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
from graph_neural_networks_torch.ops import filters as tfilters
from graph_neural_networks_torch.utils.params import load_flax_params
from graph_neural_networks_tpu import training as JT
from graph_neural_networks_tpu.data import flocking as jF
from graph_neural_networks_tpu.models import architectures_time as jarcht
from graph_neural_networks_tpu.models import layers as jlayers
from graph_neural_networks_tpu.ops import ell as jell
from graph_neural_networks_tpu.ops import filters as jfilters
from tests.test_torch_flocking import _close, _swarm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine: one intra-op thread
    keeps the many small torch ops here from oversubscribing its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(atol=1e-4, rtol=1e-4)
H = 8                        # the GRNN's hidden width
GRNN_ARGS = (6, 2, H, [3, 2], True, "tanh", "identity", "identity", [2], 1)
# nExchanges 4 of 6 features: payload width 24, fused up to ell_degree 16
AGG_ARGS = ([6, 8], [2], True, "tanh", "MaxPoolLocal", [2], [2], 1)
AGG_KW = dict(nExchanges=4)


def _t(a):
    return torch.tensor(np.asarray(a))


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, unfreeze(params))


def _jax_z0(key, B, N):
    return jax.random.normal(jax.random.PRNGKey(key), (B, H, N), jnp.float32)


class _JGrnn(jarcht.GraphRecurrentNN_DB):
    """The JAX GRNN with its forward's z0 fixed: PRNGKey(0)'s draw, the
    one its rollouts make."""

    def split_forward(self, params, x, S, rng=None, z0=None):
        if z0 is None:
            z0 = _jax_z0(0, x.shape[0], x.shape[-1])
        return super().split_forward(params, x, S, z0=z0)


class _TGrnn(tarcht.GraphRecurrentNN_DB):
    """The port's GRNN with JAX's PRNGKey(0) draw as the z0 of a forward
    and of a rollout's initial state."""

    def split_forward(self, x, S, generator=None, z0=None):
        if z0 is None:
            z0 = _t(_jax_z0(0, x.shape[0], x.shape[-1]))
        return super().split_forward(x, S, z0=z0)

    def rollout_init(self, B, N, dtype=torch.float32, z0=None):
        return super().rollout_init(B, N, dtype, z0=_t(_jax_z0(0, B, N)))


def _grnn():
    jnet = _JGrnn(*GRNN_ARGS)
    params = jnet.init(jax.random.PRNGKey(1), N=12, T=3)
    tnet = _TGrnn(*GRNN_ARGS, device="cpu")
    load_flax_params(tnet, _tree(params))
    return jnet, params, tnet


def _agg():
    jnet = jarcht.AggregationGNN_DB(*AGG_ARGS, **AGG_KW)
    params = jnet.init(jax.random.PRNGKey(2), N=12, T=3)
    tnet = tarcht.AggregationGNN_DB(*AGG_ARGS, device="cpu", **AGG_KW)
    load_flax_params(tnet, _tree(params))
    return jnet, params, tnet


@pytest.fixture(scope="module")
def nets():
    return {"grnn": _grnn(), "agg": _agg()}


def _stack(seed, lead, N, deg, E=1):
    """A random (*lead, E, N, N) GSO stack, in-degree <= deg, and its ELL
    form of width deg (numpy idx, val)."""
    rng = np.random.default_rng(seed)
    S = np.zeros(lead + (E, N, N), np.float32)
    for i in np.ndindex(*lead):
        for m in range(N):
            nbrs = rng.choice(N, size=rng.integers(1, deg + 1),
                              replace=False)
            S[i][:, nbrs, m] = 0.5 * rng.standard_normal((E, len(nbrs)))
    e = tell.ell_from_dense(S, d_max=deg)
    return S, np.asarray(e.idx), np.asarray(e.val)


def _graphs(kind, S, idx, val):
    """The stack as each package takes it: (jax, port)."""
    if kind == "dense":
        return jnp.asarray(S), _t(S)
    return jell.EllGso(jnp.asarray(idx), jnp.asarray(val)), \
        tell.EllGso(_t(idx), _t(val))


# ---------------------------------------------------------------------------
# grnn_db and HiddenStateDB
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["dense", "ell"])
def test_grnn_db_matches_jax(kind):
    """Outputs and the gradients of every input and weight (x, z0, the a
    and b taps, both biases), E = 2, K = 3."""
    rng = np.random.default_rng(3)
    B, T, F, Hh, N, E, K = 2, 5, 3, 4, 12, 2, 3
    S, idx, val = _stack(4, (B, T), N, 4, E)
    args = [rng.normal(size=s).astype(np.float32) * 0.5 for s in
            ((Hh, E, K, F), (Hh, E, K, Hh), (B, T, F, N), (B, Hh, N),
             (Hh, 1), (Hh, 1))]
    wz = rng.normal(size=(B, T, Hh, N)).astype(np.float32)
    jS, tS = _graphs(kind, S, idx, val)

    def jloss(a, b, x, z0, xb, zb):
        z = jfilters.grnn_db(a, b, jS, x, z0, jnp.tanh, xb, zb)
        return jnp.sum(z * wz), z
    (jl, jz), jg = jax.value_and_grad(jloss, argnums=tuple(range(6)),
                                      has_aux=True)(*map(jnp.asarray, args))
    targs = [_t(a).requires_grad_() for a in args]
    a, b, x, z0, xb, zb = targs
    z = tfilters.grnn_db(a, b, tS, x, z0, torch.tanh, xb, zb)
    (z * _t(wz)).sum().backward()
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(jz), **TOL)
    for got, want in zip(targs, jg):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), **TOL)


def test_hidden_state_db_matches_jax():
    """The layer with the JAX init's parameters (every one U(+-1/sqrt(F
    K)), bWeights too): (z, z[:, -1:]) on an ELL stack, and the port's own
    init within the same bound."""
    B, T, F, Hh, N = 2, 4, 3, 5, 10
    S, idx, val = _stack(5, (B, T), N, 3)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, T, F, N)).astype(np.float32)
    z0 = rng.normal(size=(B, Hh, N)).astype(np.float32)
    jS, tS = _graphs("ell", S, idx, val)
    jlayer = jlayers.HiddenStateDB(F, Hh, 3)
    params = jlayer.init(jax.random.PRNGKey(0), jnp.asarray(x),
                         jnp.asarray(z0), jS)
    jz, jlast = jlayer.apply(params, jnp.asarray(x), jnp.asarray(z0), jS)
    tlayer = tarcht.HiddenStateDB(F, Hh, 3, generator=torch.Generator(),
                                  device="cpu")
    bound = 1 / np.sqrt(F * 3)
    for p in tlayer.parameters():
        assert float(p.detach().abs().max()) <= bound
    names = tlayer.flax_names(())
    leaves = _tree(params)["params"]
    assert sorted(k[0] for k in names) == sorted(leaves)
    with torch.no_grad():
        for (name,), (p, _) in names.items():
            p.copy_(_t(leaves[name]))
        z, last = tlayer(_t(x), _t(z0), tS)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), **TOL)
    np.testing.assert_array_equal(last.numpy(), z[:, -1:].numpy())
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), **TOL)


# ---------------------------------------------------------------------------
# The architectures: split_forward and the step interface
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["dense", "ell"])
@pytest.mark.parametrize("model", ["grnn", "agg"])
def test_split_forward_matches_jax(nets, model, kind):
    """split_forward on a dense stack and on an EllGso, and the input
    gradient of a loss on the readout output."""
    jnet, params, tnet = nets[model]
    B, T, N = 2, 5, 14
    S, idx, val = _stack(6, (B, T), N, 4)
    x = np.random.default_rng(6).normal(size=(B, T, 6, N)).astype(
        np.float32)
    jS, tS = _graphs(kind, S, idx, val)
    z0 = _jax_z0(3, B, N)
    kw_j = {"z0": z0} if model == "grnn" else {}
    kw_t = {"z0": _t(z0)} if model == "grnn" else {}

    def jloss(xx):
        y, aux = jnet.split_forward(params, xx, jS, **kw_j)
        return jnp.sum(y ** 2), (y, aux)
    (_, (jy, jaux)), jgx = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(x))
    tx = _t(x).requires_grad_()
    y, aux = tnet.split_forward(tx, tS, **kw_t)
    (y ** 2).sum().backward()
    assert tuple(y.shape) == (B, T, 2, N)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(aux.detach().numpy(), np.asarray(jaux), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **TOL)
    assert tnet.parameter_count() == jnet.parameter_count(params)
    with torch.no_grad():
        one = tnet.single_node_forward(tx, tS, [3, 5], **kw_t)
    np.testing.assert_array_equal(one.numpy(),
                                  y.detach().numpy()[[0, 1], :, :, [3, 5]])


@pytest.mark.parametrize("kind", ["dense", "ell"])
@pytest.mark.parametrize("model", ["grnn", "agg"])
def test_rollout_step_matches_split_forward_and_jax(nets, model, kind):
    """The step interface at every t against split_forward over the whole
    history (the port's own), and against the JAX rollout_step fed the
    same state; payload widths as JAX's."""
    jnet, params, tnet = nets[model]
    assert tnet.payload_width == jnet.payload_width
    assert getattr(tnet, "causal_window", None) == getattr(
        jnet, "causal_window", None)
    B, T, N = 2, 6, 12
    S, idx, val = _stack(7, (B, T), N, 4)
    x = np.random.default_rng(7).normal(size=(B, T, 6, N)).astype(
        np.float32)
    _, tS = _graphs(kind, S, idx, val)
    with torch.no_grad():
        y_full = tnet(_t(x), tS).numpy()   # z0: JAX's PRNGKey(0) draw
    z0 = _jax_z0(0, B, N)
    tstate = (tnet.rollout_init(B, N) if model == "agg" else
              tarcht.GraphRecurrentNN_DB.rollout_init(tnet, B, N,
                                                      z0=_t(z0)))
    jstate = jnet.rollout_init(params, B, N)
    if model == "grnn":
        jstate = (jstate[0], jnp.swapaxes(z0, -1, -2)) + jstate[2:]
    for t in range(T):
        if kind == "dense":
            jS_t, tS_t = jnp.asarray(S[:, t]), _t(S[:, t])
        else:
            jS_t = jell.EllGso(jnp.asarray(idx[:, t]), jnp.asarray(val[:, t]))
            tS_t = tS.time_step(t)
        with torch.no_grad():
            tstate, ty = tnet.rollout_step(tstate, _t(x[:, t]), tS_t)
        jstate, jy = jnet.rollout_step(params, jstate, jnp.asarray(x[:, t]),
                                       jS_t)
        _close(ty.numpy(), y_full[:, t], rtol=1e-4, atol_rel=1e-5)
        _close(ty.numpy(), jy, rtol=1e-4, atol_rel=1e-5)
        np.testing.assert_allclose(
            tnet.rollout_payload(tstate).numpy(),
            np.asarray(jnet.rollout_payload(jstate)), **TOL)


# ---------------------------------------------------------------------------
# Grid rollouts: unfused and fused
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def swarm():
    """A 128-agent, 2-sample swarm of both packages; T = 6."""
    jenv = jF.Flocking.for_rollout(128, 2.0, 1.0, 0.01,
                                   rng=np.random.default_rng(8))
    tenv, ip, iv = _swarm(128, 2, 8)
    return jenv, tenv, ip, iv


ROLLOUTS = [  # (model, ell_degree, fused?)
    ("grnn", 16, False), ("agg", 16, True), ("agg", 14, False)]


@pytest.mark.parametrize("model,D,fused", ROLLOUTS)
def test_grid_rollout_matches_jax(nets, swarm, model, D, fused):
    """compute_trajectory and rollout_cost on the grid env against JAX's
    step_mode=True rollouts: the GRNN (payload 36 > 1.5 * 16) unfused,
    AggregationGNN_DB (payload 24) fused at ell_degree 16 and unfused at
    14. The emitted graphs match, and "auto" keeps them exactly when the
    rollout is unfused."""
    jnet, params, tnet = nets[model]
    assert (tnet.payload_width <= 1.5 * D) == fused
    jenv, tenv, ip, iv = swarm
    kw = dict(ell_degree=D, env_grid=True, lam_iters=2, step_mode=True)
    got = tenv.compute_trajectory(ip, iv, 0.06, tnet, **kw)
    want = jenv.compute_trajectory(ip, iv, 0.06, archit=jnet, params=params,
                                   **kw)
    for a, b in zip(got[:2], want[:2]):                  # pos, vel
        assert a.shape == (2, 6, 2, 128)
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    _close(got[2], want[2], rtol=1e-4, atol_rel=1e-5, axis=2)   # accel
    _close(got[3], want[3], rtol=1e-4, atol_rel=1e-5, axis=2)   # states
    np.testing.assert_array_equal(got[4].idx, np.asarray(want[4].idx))
    _close(got[4].val, np.asarray(want[4].val))
    cf, ce = tenv.rollout_cost(ip, iv, 0.06, tnet, **kw)
    jcf, jce = jenv.rollout_cost(ip, iv, 0.06, jnet, params, **kw)
    np.testing.assert_allclose([cf, ce], [jcf, jce], rtol=1e-5)
    auto = tenv.compute_trajectory(ip, iv, 0.06, tnet, return_graphs="auto",
                                   **kw)
    assert auto[4].idx.shape[-1] == (0 if fused else D)
    np.testing.assert_array_equal(auto[1], got[1])


def test_unfused_rollout_flags_an_in_degree_above_ell_degree(nets, swarm):
    """The port's divergence from the JAX package (ROADMAP queue 3): an
    unfused policy shifts over the emitted graph, cut at ell_degree, so
    the port's ok also requires every in-degree to fit it (JAX's covers
    cell overflow only): strict mode raises at ell_degree 2, not at 16."""
    _, _, tnet = nets["grnn"]
    _, tenv, ip, iv = swarm
    kw = dict(env_grid=True, lam_iters=2, env_grid_strict=True)
    tenv.rollout_cost(ip, iv, 0.03, tnet, ell_degree=16, **kw)
    with pytest.raises(RuntimeError, match="in-degree exceeded d_max"):
        tenv.rollout_cost(ip, iv, 0.03, tnet, ell_degree=2, **kw)


def test_unfused_rollout_refuses_return_graphs_false(nets, swarm):
    _, _, tnet = nets["grnn"]
    _, tenv, ip, iv = swarm
    with pytest.raises(ValueError, match="requires the fused"):
        tenv.compute_trajectory(ip, iv, 0.03, tnet, ell_degree=16,
                                env_grid=True, return_graphs=False)


# ---------------------------------------------------------------------------
# TrainerFlocking: one step over each store, and evaluate_flocking
# ---------------------------------------------------------------------------

# the host store: 10 agents, T = 5; the grid device store: 32 agents, T = 5
HOST = dict(nAgents=10, commRadius=2.0, repelDist=1.0, nTrain=2, nValid=1,
            nTest=1, duration=0.5, samplingTime=0.1)
GRID = dict(commRadius=2.0, repelDist=1.0, nTrain=2, nValid=1, nTest=1,
            duration=0.5, samplingTime=0.1, ell_degree=16)


@pytest.fixture(scope="module")
def datasets():
    jh = jF.Flocking(rng=np.random.default_rng(9), **HOST)
    th = tF.Flocking(rng=np.random.default_rng(9), device="cpu", **HOST)
    jd = jF.Flocking.large_device(32, rng=np.random.default_rng(10), **GRID)
    td = tF.Flocking.large_device(32, rng=np.random.default_rng(10),
                                  device="cpu", **GRID)
    for split in ("train", "valid", "test"):    # one store for both
        td.pos[split] = _t(jd.pos[split])
        td.vel[split] = _t(jd.vel[split])
    return {"host": (jh, th), "device": (jd, td)}


def _models(model, tmp_path, N):
    jarc = (_JGrnn(*GRNN_ARGS) if model == "grnn" else
            jarcht.AggregationGNN_DB(*AGG_ARGS, **AGG_KW))
    jm = JT.Model(jarc, JT.losses.mse_loss, {"name": "ADAM", "lr": 5e-3},
                  JT.TrainerFlocking, JT.evaluate_flocking, name=model,
                  saveDir=str(tmp_path / "jax"), N=N, T=3, seed=3)
    tarc = (_TGrnn(*GRNN_ARGS, device="cpu") if model == "grnn" else
            tarcht.AggregationGNN_DB(*AGG_ARGS, device="cpu", **AGG_KW))
    load_flax_params(tarc, _tree(jm.params))
    tm = TT.Model(tarc, TT.losses.mse_loss, {"name": "ADAM", "lr": 5e-3},
                  TT.TrainerFlocking, TT.evaluate_flocking, name=model,
                  saveDir=str(tmp_path / "torch"))
    return jm, tm


@pytest.fixture(scope="module")
def trained(datasets, tmp_path_factory):
    """Each model trained one step (batch 2) over each store from one
    init, validated at that step by a closed-loop rollout."""
    out = {}
    for store in ("host", "device"):
        jd, td = datasets[store]
        kw = (dict(deviceStore=True, ellDegree=16) if store == "device"
              else {})
        for model in ("grnn", "agg"):
            jm, tm = _models(model, tmp_path_factory.mktemp(store + model),
                             10 if store == "host" else 32)
            jout = jm.train(jd, 1, 2, validationInterval=1, seed=4, **kw)
            tout = tm.train(td, 1, 2, validationInterval=1, seed=4, **kw)
            out[store, model] = (jm, tm, jout, tout)
    return out


@pytest.mark.parametrize("model", ["grnn", "agg"])
@pytest.mark.parametrize("store", ["host", "device"])
def test_trainer_flocking_step_matches_jax(trained, store, model):
    """The step's loss, the validation cost of its closed-loop rollout
    (the device store's GRNN unfused, AggGNN fused) and every parameter
    after the Adam step against the JAX trainer's."""
    jm, tm, jout, tout = trained[store, model]
    assert len(tout["lossTrain"]) == 1
    np.testing.assert_allclose(tout["lossTrain"], jout["lossTrain"], **TOL)
    np.testing.assert_allclose(tout["costValid"], jout["costValid"], **TOL)
    leaves = _tree(jm.params)["params"]
    for path, (p, perm) in tm.archit.flax_names().items():
        want = leaves
        for k in path:
            want = want[k]
        got = p.detach().numpy()
        got = (np.transpose(got, perm) if isinstance(perm, tuple)
               else got.T if perm else got)
        np.testing.assert_allclose(got, want, **TOL)


def test_evaluate_flocking_matches_jax(datasets, trained):
    """The closed-loop test cost of the Best and Last checkpoints, the
    GRNN's over the grid's unfused rollout."""
    jd, td = datasets["device"]
    jm, tm, _, _ = trained["device", "grnn"]
    want = JT.evaluate_flocking(jm, jd)
    got = TT.evaluate_flocking(tm, td)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL)


def test_trainer_passes_its_generator_to_split_forward(datasets, tmp_path):
    """Without a fixed z0 the trainer's forward draws from its own
    generator, which advances every step: two steps see two z0s."""
    seen = []

    class Recording(tarcht.GraphRecurrentNN_DB):
        def split_forward(self, x, S, generator=None, z0=None):
            seen.append(generator)
            return super().split_forward(x, S, generator=generator, z0=z0)

    _, td = datasets["device"]
    tm = TT.Model(Recording(*GRNN_ARGS, device="cpu"), TT.losses.mse_loss,
                  {"name": "ADAM", "lr": 5e-3}, TT.TrainerFlocking,
                  TT.evaluate_flocking, name="gen", saveDir=str(tmp_path))
    out = tm.train(td, 1, 1, validationInterval=5, deviceStore=True,
                   ellDegree=16, seed=4)
    assert len(seen) == 2 and seen[0] is seen[1] is not None
    assert np.isfinite(out["lossTrain"]).all()
