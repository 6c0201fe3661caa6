"""PyTorch port, the training slice: training/losses.py, Model, Trainer,
evaluate, data/SourceLocalization and the graph helpers it needs, held
against the JAX package on the CPU.

Both Trainers start from the same weights (flax params carried across by
load_flax_params), see the same batches (np.random.default_rng(seed)
permutations) and use the same optimizer (optax.adam / torch.optim.Adam,
empty state). The JAX band-mode SelectionGNN runs its Pallas kernels in
TPU interpret mode; the JAX band GAT runs its XLA band path (the CPU
backend); the port runs the kernels' plain versions through their autograd
Functions.

Tolerances: losses atol = rtol = 1e-6 (the same f32 formula); loss
trajectories rtol 1e-4 (10 Adam steps over two filter layers of f32 sums
in another order); dataset arrays bit for bit (the same numpy calls).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.core import unfreeze
from jax.experimental.pallas import tpu as pltpu

from graph_neural_networks_torch import data as tdata
from graph_neural_networks_torch import training as ttrain
from graph_neural_networks_torch.models import architectures as tarch
from graph_neural_networks_torch.utils import graph as tgt
from graph_neural_networks_torch.utils import misc as tmisc
from graph_neural_networks_torch.utils.params import load_flax_params
from graph_neural_networks_tpu import data as jdata
from graph_neural_networks_tpu import training as jtrain
from graph_neural_networks_tpu.models import architectures as jarch
from graph_neural_networks_tpu.utils import graph as jgt
from graph_neural_networks_tpu.utils import misc as jmisc

LOSS_TOL = dict(atol=1e-6, rtol=1e-6)
TRAJ_RTOL = 1e-4

SBM = {"nCommunities": 3, "probIntra": 0.8, "probInter": 0.2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine: one intra-op thread
    keeps the many small torch ops here from oversubscribing its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _loss_inputs(name, rng):
    if name == "cross_entropy_loss":
        return (rng.standard_normal((6, 4)).astype(np.float32),
                rng.integers(0, 4, 6))
    if name == "f1_score_loss":
        return (rng.standard_normal((3, 2, 7)).astype(np.float32),
                (rng.random((3, 7)) < 0.4).astype(np.float32))
    if name == "adapt_extra_dimension_loss":
        return (rng.standard_normal((6, 1)).astype(np.float32),
                rng.standard_normal(6).astype(np.float32))
    return (rng.standard_normal((5, 3)).astype(np.float32) * 2,
            rng.standard_normal((5, 3)).astype(np.float32))


@pytest.mark.parametrize("name", [
    "cross_entropy_loss", "mse_loss", "l1_loss", "smooth_l1_loss",
    "adapt_extra_dimension_loss", "f1_score_loss"])
def test_losses_match_jax(name):
    est, tgt = _loss_inputs(name, np.random.default_rng(len(name)))
    tfn, jfn = getattr(ttrain.losses, name), getattr(jtrain.losses, name)
    if name == "adapt_extra_dimension_loss":
        tfn, jfn = tfn(ttrain.losses.mse_loss), jfn(jtrain.losses.mse_loss)
    te = torch.from_numpy(est).requires_grad_()
    got = tfn(te, torch.from_numpy(tgt))
    got.backward()
    want, jgrad = jax.value_and_grad(jfn)(jnp.asarray(est), jnp.asarray(tgt))
    np.testing.assert_allclose(got.item(), float(want), **LOSS_TOL)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(jgrad), **LOSS_TOL)


def test_f1_loss_degenerate_batch_matches_jax():
    """No positive labels and a confident negative: the reference's NaN
    guards give 1 - F1 = 0 on both sides."""
    est = np.zeros((1, 2, 4), np.float32)
    est[:, 0] = 20.0
    y = np.zeros((1, 4), np.float32)
    got = ttrain.losses.f1_score_loss(torch.from_numpy(est),
                                      torch.from_numpy(y))
    want = jtrain.losses.f1_score_loss(jnp.asarray(est), jnp.asarray(y))
    np.testing.assert_allclose(got.item(), float(want), atol=1e-6)


def _source_loc(mod_gt, mod_data, N, seed, n=(40, 12, 12)):
    G = mod_gt.Graph("SBM", N, SBM, rng=np.random.default_rng(seed))
    srcs = mod_gt.compute_source_nodes(G.A, 3)
    data = mod_data.SourceLocalization(G, *n, srcs, tMax=3,
                                       rng=np.random.default_rng(seed + 1))
    data.astype(np.float64)
    data.expandDims()
    return G, srcs, data


def test_source_localization_equals_jax():
    tG, tsrc, td = _source_loc(tgt, tdata, 30, 0)
    jG, jsrc, jd = _source_loc(jgt, jdata, 30, 0)
    assert tsrc == jsrc
    for name in ("W", "A", "D", "L"):
        assert np.array_equal(getattr(tG, name), getattr(jG, name)), name
    for split in ("train", "valid", "test"):
        tx, ty = td.getSamples(split)
        jx, jy = jd.getSamples(split)
        assert tx.shape == (td.nTrain if split == "train" else 12, 1, 30)
        assert np.array_equal(tx, jx) and np.array_equal(ty, jy), split
    idx = np.array([3, 0, 7])
    for a, b in zip(td.getSamples("train", idx), jd.getSamples("train", idx)):
        assert np.array_equal(a, b)
    yhat = np.random.default_rng(2).standard_normal((12, 3))
    assert td.evaluate(yhat, td.getSamples("test")[1]) == \
        jd.evaluate(yhat, jd.getSamples("test")[1])


def test_graph_helpers_equal_jax():
    rng = np.random.default_rng(3)
    W = rng.random((12, 12))
    W = W + W.T
    for order in ("no", "increasing", "totalVariation"):
        for a, b in zip(tgt.compute_gft(W, order), jgt.compute_gft(W, order)):
            np.testing.assert_allclose(a, b, atol=1e-12)
    assert np.array_equal(tgt.matrix_powers(W, 4), jgt.matrix_powers(W, 4))
    assert np.array_equal(tgt.adjacency_to_laplacian(W),
                          jgt.adjacency_to_laplacian(W))
    assert tgt.is_connected(W) and not tgt.is_connected(np.eye(4))
    opts = {"probEdge": 0.3, "probRewiring": 0.2}
    assert np.array_equal(
        tgt.create_graph("SmallWorld", 10, opts, np.random.default_rng(4)),
        jgt.create_graph("SmallWorld", 10, opts, np.random.default_rng(4)))
    with pytest.raises(ValueError, match="graph type"):
        tgt.create_graph("Geometric", 10, {})


def test_misc_helpers_equal_jax(tmp_path):
    rec = {"step": 3, "loss": np.float32(0.5)}
    for mod, name in ((tmisc, "t"), (jmisc, "j")):
        mod.write_var_values(str(tmp_path / name / "vars.txt"),
                             {"lr": 0.1, "K": 3})
        mod.append_jsonl(str(tmp_path / name / "m.jsonl"), rec)
    for f in ("vars.txt", "m.jsonl"):
        assert (tmp_path / "t" / f).read_text() == \
            (tmp_path / "j" / f).read_text()


# ---------------------------------------------------------------------------
# Trainer against the JAX Trainer
# ---------------------------------------------------------------------------

N_TRAIN = 150   # two 128-blocks (ragged) in band mode, w = 1

ARCHS = {
    "selgnn_band": (jarch.SelectionGNN, tarch.SelectionGNN,
                    ([1, 4, 4], [3, 2], True, "relu", [N_TRAIN, N_TRAIN],
                     "NoPool", [1, 1], [3]), dict(gsoMode="band")),
    "gat_band": (jarch.GraphAttentionNetwork, tarch.GraphAttentionNetwork,
                 ([1, 4, 4], [2, 2], "relu", [N_TRAIN, N_TRAIN], "NoPool",
                  [1, 1], [3], True), dict(attentionMode="band")),
}


@pytest.fixture(scope="module")
def sbm_data():
    G, _, data = _source_loc(jgt, jdata, N_TRAIN, 5, n=(40, 10, 10))
    return G.W / np.max(np.abs(np.linalg.eigvalsh(G.W))), data


def _models(kind, S, tmp_path, opt=None):
    """The JAX Model and the port's Model on the same weights."""
    cls_j, cls_t, args, kw = ARCHS[kind]
    opt = opt or {"name": "ADAM", "lr": 5e-3}
    with pltpu.force_tpu_interpret_mode():
        jm = jtrain.Model(cls_j(*args, S, **kw), jtrain.losses.
                          cross_entropy_loss, opt, jtrain.Trainer,
                          jtrain.evaluate, name="j", saveDir=str(tmp_path),
                          seed=0)
    ta = cls_t(*args, S, device="cpu", **kw)
    load_flax_params(ta, jax.tree_util.tree_map(np.asarray,
                                                unfreeze(jm.params)))
    tm = ttrain.Model(ta, ttrain.losses.cross_entropy_loss, opt,
                      ttrain.Trainer, ttrain.evaluate, name="t",
                      saveDir=str(tmp_path))
    assert tm.nParameters == jm.nParameters
    return jm, tm


@pytest.mark.parametrize("decay", [False, True], ids=["adam", "decay"])
@pytest.mark.parametrize("kind", sorted(ARCHS))
def test_trainer_trajectory_matches_jax(kind, decay, sbm_data, tmp_path):
    """10 steps (batch 8: 5 batches an epoch, two epochs), validation
    every 3 steps, Best/Last checkpoints, then evaluate."""
    S, data = sbm_data
    jm, tm = _models(kind, S, tmp_path)
    kw = dict(nEpochs=2, batchSize=8, validationInterval=3)
    if decay:
        kw.update(learningRateDecayRate=0.5, learningRateDecayPeriod=1)
    with pltpu.force_tpu_interpret_mode():
        jout = jm.train(data, **kw)
        jeval = jm.evaluate(data, doSaveVars=False)
    tout = tm.train(data, **kw)
    teval = tm.evaluate(data)
    assert len(tout["lossTrain"]) == 10
    np.testing.assert_allclose(tout["lossTrain"], jout["lossTrain"],
                               rtol=TRAJ_RTOL)
    np.testing.assert_allclose(tout["costValid"], jout["costValid"])
    assert (tout["bestEpoch"], tout["bestBatch"]) == \
        (jout["bestEpoch"], jout["bestBatch"])
    assert teval == jeval
    assert os.path.exists(tmp_path / "evalVars" / "tevalVars.pkl")


def test_lr_decay_schedule_matches_optax():
    p = torch.nn.Parameter(torch.zeros(2))
    opt = torch.optim.SGD([p], lr=0.1)
    sched = ttrain.trainer.staircase_decay(0.5, 6)(opt)
    want = optax.exponential_decay(0.1, transition_steps=6, decay_rate=0.5,
                                   staircase=True)
    for step in range(20):
        np.testing.assert_allclose(opt.param_groups[0]["lr"],
                                   float(want(step)), rtol=1e-6)
        opt.step()
        sched.step()


@pytest.mark.parametrize("name", ["ADAM", "SGD", "RMSprop"])
def test_optimizers_match_optax(name):
    """Three updates of each optimizer against optax on the same
    gradients (RMSprop's eps sits outside the root in torch, inside in
    optax: invisible at these magnitudes)."""
    spec = {"name": name, "lr": 0.05, "momentum": 0.9}
    rng = np.random.default_rng(4)
    x0 = rng.standard_normal(5)
    # |g| >= 0.5: the eps placement is then far below the tolerance
    grads = [np.sign(rng.standard_normal(5)) * (0.5 + rng.random(5))
             for _ in range(3)]
    p = torch.nn.Parameter(torch.tensor(x0))
    opt = ttrain.make_optimizer(spec, [p])
    jopt = jtrain.model.make_optimizer(spec)
    jx = jnp.asarray(x0, jnp.float32)
    state = jopt.init(jx)
    for g in grads:
        p.grad = torch.tensor(g)
        opt.step()
        upd, state = jopt.update(jnp.asarray(g, jnp.float32), state, jx)
        jx = optax.apply_updates(jx, upd)
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jx),
                               rtol=1e-5, atol=1e-6)


def _small_model(S, d):
    arch = tarch.SelectionGNN([1, 4], [3], True, "relu", [S.shape[0]],
                              "NoPool", [1], [3], S, gsoMode="band",
                              device="cpu")
    return ttrain.Model(arch, ttrain.losses.cross_entropy_loss,
                        {"name": "ADAM", "lr": 5e-3}, ttrain.Trainer,
                        ttrain.evaluate, name="m", saveDir=str(d))


def test_checkpoint_roundtrip_and_resume(sbm_data, tmp_path):
    """Best/Last save and load restore parameters and optimizer state;
    4 + 4 resumed epochs (with lr decay) reproduce the exact trajectory of
    an uninterrupted 8-epoch run."""
    S, data = sbm_data
    m = _small_model(S, tmp_path / "rt")
    p0 = [p.detach().clone() for p in m.archit.parameters()]
    m.save("Best")
    with torch.no_grad():
        for p in m.archit.parameters():
            p.add_(1.0)
    assert m.load("Best") is None
    for a, b in zip(p0, m.archit.parameters()):
        assert torch.equal(a, b)
    with pytest.raises(FileNotFoundError):
        m.load("Last")

    kw = dict(batchSize=12, validationInterval=3, learningRateDecayRate=0.7,
              learningRateDecayPeriod=2, metricsFile=str(tmp_path / "m.jsonl"))
    full = _small_model(S, tmp_path / "full").train(data, nEpochs=8, **kw)
    part = _small_model(S, tmp_path / "part")
    part.train(data, nEpochs=4, **kw)
    out = part.train(data, nEpochs=8, resume=True, **kw)
    np.testing.assert_allclose(out["lossTrain"], full["lossTrain"],
                               rtol=1e-6)
    assert len(out["lossTrain"]) == 8 * 4   # uneven last batch of 4
    assert (tmp_path / "m.jsonl").read_text().count("\n") > 0


def test_trainer_unported_options_raise(sbm_data, tmp_path):
    S, data = sbm_data
    m = _small_model(S, tmp_path)
    from graph_neural_networks_torch import parallel as tpar
    # bf16 of a sharded model trains since item 2.1, of an edge-list
    # context since item 2.2 (this assertion refused it before)
    edge = ttrain.Model(tarch.SelectionGNN(
        [1, 4], [3], True, "relu", [S.shape[0]], "NoPool", [1], [3], S,
        gsoMode="edge", device="cpu"), ttrain.losses.cross_entropy_loss,
        {"name": "ADAM", "lr": 5e-3}, ttrain.Trainer, ttrain.evaluate,
        name="e", saveDir=str(tmp_path / "edge"))
    loss, _ = ttrain.Trainer(edge, data, 1, 8, precision="bf16").train_batch(
        np.arange(8))
    assert np.isfinite(loss)
    sharded = _small_model(S, tmp_path / "sharded")
    sharded.archit.shard(tpar.make_mesh((1, 2), devices=[
        torch.device("cpu")] * 2), 2)
    ttrain.Trainer(sharded, data, 1, 8, precision="bf16")
    with pytest.raises(TypeError, match="parallel.Mesh"):
        ttrain.Trainer(m, data, 1, 8, mesh=object())
    mesh = tpar.make_mesh((2,), ("data",), devices=[
        torch.device("cpu"), torch.device("cuda", 0)])
    with pytest.raises(NotImplementedError, match="item 10.2b"):
        ttrain.Trainer(m, data, 1, 8, mesh=mesh)
    ttrain.Trainer(m, data, 1, 8, scanDispatch=True, scanMemoryBudget=1)
