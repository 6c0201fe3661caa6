"""PyTorch port, the single-node path: ``TrainerSingleNode`` and
``evaluate_single_node`` against the JAX package's on a small synthetic
MovieLens movie graph, the Local GNN's weights carried across by
load_flax_params. The port runs in dense mode and in bcsr mode (the
kernel's plain version), the JAX side in dense mode.

Tolerances: the first step's loss, gradients and updated parameters, and
the evaluation costs after a trained epoch, atol = rtol = 1e-5 (the same
f32 formulas, sums in another order); node positions exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from graph_neural_networks_torch import data as tdata
from graph_neural_networks_torch import training as ttrain
from graph_neural_networks_torch.models import architectures as tarch
from graph_neural_networks_torch.utils.params import load_flax_params
from graph_neural_networks_tpu import data as jdata
from graph_neural_networks_tpu import training as jtrain
from graph_neural_networks_tpu.models import architectures as jarch

TOL = dict(atol=1e-5, rtol=1e-5)
ML = dict(kNN=4, nSynthUsers=90, nSynthMovies=40)
BATCH = 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine: one intra-op thread
    keeps the many small torch ops here from oversubscribing its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _movielens(mod, lid):
    data = mod.MovieLens("movie", lid, 0.8, 0.2,
                         rng=np.random.default_rng(0), **ML)
    data.expandDims()
    return data


@pytest.fixture(scope="module")
def task():
    """The most-rated movie that the graph keeps (as the card's
    movielens_n1186), its datasets in both packages and S = W/λmax."""
    M = tdata.MovieLens._synthesize(np.random.default_rng(0),
                                    ML["nSynthUsers"], ML["nSynthMovies"])
    for lid in np.argsort(-(M > 0).sum(0), kind="stable"):
        try:
            td = _movielens(tdata, int(lid))
            break
        except ValueError:
            continue
    jd = _movielens(jdata, int(lid))
    W = td.getGraph()
    S = W / np.max(np.abs(np.linalg.eigvalsh(W)))
    return td, jd, S


def _loss(mod):
    return mod.losses.adapt_extra_dimension_loss(mod.losses.smooth_l1_loss)


def _models(S, mode, tmp_path, layers=2):
    N = S.shape[0]
    F, K = [1, 8, 4][:layers + 1], [3, 3][:layers]
    args = (F, K, True, "relu", [N] * layers, "NoPool", [1] * layers, [1], S)
    opt = {"name": "ADAM", "lr": 5e-3}
    jm = jtrain.Model(jarch.LocalGNN(*args, order="Degree"), _loss(jtrain),
                      opt, jtrain.TrainerSingleNode,
                      jtrain.evaluate_single_node, name="j",
                      saveDir=str(tmp_path / "j"), seed=0)
    ta = tarch.LocalGNN(*args, order="Degree", gsoMode=mode, device="cpu")
    load_flax_params(ta, jax.tree_util.tree_map(np.asarray,
                                                unfreeze(jm.params)))
    tm = ttrain.Model(ta, _loss(ttrain), opt, ttrain.TrainerSingleNode,
                      ttrain.evaluate_single_node, name="t",
                      saveDir=str(tmp_path / "t"))
    assert ta.order == list(jm.archit.order)
    assert tm.nParameters == jm.nParameters
    return jm, tm


def _as_torch_layout(tree, names):
    """JAX leaves (gradients, parameters) in the port's parameter layout."""
    from graph_neural_networks_torch.utils.params import _flatten
    leaves = dict(_flatten(tree["params"]))
    out = []
    for path, (p, transpose) in names.items():
        v = np.asarray(leaves[path])
        if isinstance(transpose, tuple):
            v = np.transpose(v, transpose)
        elif transpose:
            v = v.T
        out.append((path, p, v))
    return out


@pytest.mark.parametrize("mode", ["dense", "bcsr"])
def test_first_step_matches_jax(task, mode, tmp_path):
    """The first batch of the trainers' shared permutation: target node
    positions, the loss at them, every gradient, and the parameters after
    the Adam step."""
    td, jd, S = task
    jm, tm = _models(S, mode, tmp_path)
    assert tm.archit.S.mode == mode
    jtr = jtrain.TrainerSingleNode(jm, jd, 1, BATCH)
    ttr = ttrain.TrainerSingleNode(tm, td, 1, BATCH)
    idx = np.random.default_rng(0).permutation(td.nTrain)[:BATCH]
    x, y, pos = jtr._train_batch_data(idx)
    ids = td.getLabelID("train", idx)
    assert np.array_equal(ttr._node_positions(ids).numpy(), np.asarray(pos))

    def objective(p):
        return jm.loss(jtr._forward(p, jnp.asarray(x, jnp.float32), pos),
                       jnp.asarray(y))
    jloss, jgrads = jax.value_and_grad(objective)(jm.params)
    names = tm.archit.flax_names()
    before = {path: p.detach().clone() for path, (p, _) in names.items()}
    tloss, _ = ttr.train_batch(idx)
    np.testing.assert_allclose(tloss, float(jloss), **TOL)
    for path, p, g in _as_torch_layout(unfreeze(jgrads), names):
        np.testing.assert_allclose(p.grad.numpy(), g, **TOL,
                                   err_msg="/".join(path))
    jm.params, jm.opt_state, _ = jtr._step(
        jm.params, jm.opt_state, jnp.asarray(x, jnp.float32), jnp.asarray(y),
        pos, jtr._next_key())
    for path, p, v in _as_torch_layout(unfreeze(jm.params), names):
        assert not torch.equal(p.detach(), before[path])
        np.testing.assert_allclose(p.detach().numpy(), v, **TOL,
                                   err_msg="/".join(path))


@pytest.mark.parametrize("mode", ["dense", "bcsr"])
def test_trained_epoch_and_evaluation_match_jax(task, mode, tmp_path):
    """One epoch (an uneven last batch), validation every 3 steps, the
    Best/Last checkpoints, then evaluate_single_node on the test split's
    target ids; its evalVars pickle is written as the JAX one is."""
    td, jd, S = task
    jm, tm = _models(S, mode, tmp_path, layers=1)
    kw = dict(nEpochs=1, batchSize=BATCH, validationInterval=3)
    jout = jm.train(jd, **kw)
    tout = tm.train(td, **kw)
    assert len(tout["lossTrain"]) == int(np.ceil(td.nTrain / BATCH))
    np.testing.assert_allclose(tout["lossTrain"], jout["lossTrain"],
                               rtol=1e-4)
    np.testing.assert_allclose(tout["costValid"], jout["costValid"],
                               rtol=1e-4)
    assert tout["bestBatch"] == jout["bestBatch"]
    jeval = jm.evaluate(jd)
    teval = tm.evaluate(td)
    for key in ("costBest", "costLast"):
        np.testing.assert_allclose(teval[key], jeval[key], **TOL)
    assert (tmp_path / "t" / "evalVars" / "tevalVars.pkl").exists()
    assert ttrain.evaluateSingleNode is ttrain.evaluate_single_node
    # the evaluator's forward is single_node_forward at the test ids (the
    # model holds the Last checkpoint, which evaluate loads second)
    with torch.no_grad():
        y = tm.archit.single_node_forward(td.getSamples("test")[0],
                                          list(td.getLabelID("test")))
    assert tuple(y.shape) == (td.nTest, 1)
    assert td.evaluate(y.numpy(), td.getSamples("test")[1]) == \
        pytest.approx(teval["costLast"], rel=1e-6)
