"""PyTorch port, TrainerFlocking's host-numpy store: Flocking(...)'s dense
store with every DAGger type, Flocking.large's ELL store, the dense
device store and the dense store on ELL graphs of width ellDegree, held
against the JAX trainer on the CPU with the same inputs and weights
(moved from tests/test_torch_flocking_host.py, whose datasets and helpers
they use). Tolerances: the trainers' losses and parameters after several
Adam steps rtol = atol = 1e-4.
"""

import numpy as np
import pytest
import torch

from graph_neural_networks_torch import training as TT
from graph_neural_networks_torch.ops import ell as tell
from graph_neural_networks_tpu import training as JT

from tests.test_torch_flocking_host import (
    N_LARGE, TOL, _dense, _large, _models, _recording, _same_params)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine: one intra-op thread
    keeps the many small torch ops here from oversubscribing its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dagger", [None, "randomEpoch", "replaceTimeBatch",
                                    "fixedBatch"])
def test_host_store_training_matches_jax(tmp_path, dagger):
    """TrainerFlocking's host store over Flocking(...) from JAX's init, with
    each DAGger type: per-step losses, validation costs, the final (Best)
    parameters, and the initial conditions of every re-roll (the DAGger
    selections) against the JAX trainer's."""
    jd, td = _dense()
    jm, tm = _models(tmp_path)
    kw = dict(validationInterval=2, seed=6)
    if dagger:
        kw.update(probExpert=0.5, DAGgerType=dagger)
    jlog, tlog = [], []
    jout = _recording(JT.TrainerFlocking, jlog)(jm, jd, 3, 3, **kw).train()
    ttr = _recording(TT.TrainerFlocking, tlog)(tm, td, 3, 3, **kw)
    tout = ttr.train()
    np.testing.assert_allclose(tout["lossTrain"], jout["lossTrain"], **TOL)
    np.testing.assert_allclose(tout["costValid"], jout["costValid"], **TOL)
    assert len(tout["lossTrain"]) == 9
    assert (tout["bestEpoch"], tout["bestBatch"]) == (
        jout["bestEpoch"], jout["bestBatch"])
    _same_params(jm, tm)
    assert len(tlog) == len(jlog) == (0 if dagger is None else
                                      {"randomEpoch": 2, "fixedBatch": 8,
                                       "replaceTimeBatch": 8}[dagger])
    for a, b in zip(tlog, jlog):
        np.testing.assert_array_equal(a, b)
    # the originals stay; a re-roll changed the working copies
    np.testing.assert_array_equal(ttr.xOrig, td.getData("state", "train"))
    if dagger in ("randomEpoch", "replaceTimeBatch"):
        assert (ttr.xAll != ttr.xOrig).any()


@pytest.mark.parametrize("dagger", ["randomEpoch", "fixedBatch"])
def test_large_host_store_training_matches_jax(tmp_path, dagger):
    """The ELL host store of Flocking.large: re-rolls on the grid, the grid
    relabel, the ELL _S_setitem / _S_concat, losses and selections against
    JAX's, the re-rolled graphs kept f32."""
    jd, td = _large()
    jm, tm = _models(tmp_path)
    kw = dict(validationInterval=2, seed=6, ellDegree=16, probExpert=0.5,
              DAGgerType=dagger)
    jlog, tlog = [], []
    jout = _recording(JT.TrainerFlocking, jlog)(jm, jd, 2, 3, **kw).train()
    ttr = _recording(TT.TrainerFlocking, tlog)(tm, td, 2, 3, **kw)
    tout = ttr.train()
    np.testing.assert_allclose(tout["lossTrain"], jout["lossTrain"], **TOL)
    np.testing.assert_allclose(tout["costValid"], jout["costValid"], **TOL)
    _same_params(jm, tm)
    assert len(tlog) == len(jlog) > 0
    for a, b in zip(tlog, jlog):
        np.testing.assert_array_equal(a, b)
    assert ttr._is_ell(ttr.SAll) and ttr.SAll.val.dtype == np.float32
    xs, ys, Ss = ttr._rollout_policy(tlog[0], td.getData("initVel", "train")[
        :len(tlog[0])])
    assert isinstance(Ss, tell.EllGso) and Ss.val.dtype == np.float32
    assert Ss.idx.shape == (len(tlog[0]), 5, N_LARGE, 16)


def test_dense_device_store_matches_jax(tmp_path):
    """TrainerFlocking(deviceStore=True) over Flocking(...): the dense
    recompute on the device, randomEpoch re-rolls through the all-pairs
    loop; losses, validation costs and parameters against the JAX device
    store, and its first-step loss equal to the host store's."""
    jd, td = _dense()
    jm, tm = _models(tmp_path)
    kw = dict(validationInterval=2, seed=6, deviceStore=True, probExpert=0.5,
              DAGgerType="randomEpoch")
    jout = jm.train(jd, 2, 3, **kw)
    tout = tm.train(td, 2, 3, **kw)
    np.testing.assert_allclose(tout["lossTrain"], jout["lossTrain"], **TOL)
    np.testing.assert_allclose(tout["costValid"], jout["costValid"], **TOL)
    _same_params(jm, tm)
    _, hm = _models(tmp_path / "host")
    host = TT.TrainerFlocking(hm, td, 1, 3, seed=6)
    _, dm = _models(tmp_path / "device")
    device = TT.TrainerFlocking(dm, td, 1, 3, seed=6, deviceStore=True)
    idx = np.array([5, 0, 2])
    np.testing.assert_allclose(device.train_batch(idx)[0],
                               host.train_batch(idx)[0], rtol=1e-5)
    with pytest.raises(ValueError, match="ellDegree requires a grid"):
        TT.TrainerFlocking(tm, td, 1, 3, deviceStore=True, ellDegree=4)


def test_host_store_with_ell_degree_matches_jax(tmp_path):
    """A dense store trained on ELL graphs of width ellDegree (converted
    each batch on the host) and rolled out with top-D ELL graphs, as JAX
    examples/flocking.py --ellDegree sets it up."""
    jd, td = _dense()
    for d in (jd, td):
        d.rollout_ell_degree, d.rollout_lam_method = 6, "power"
    jm, tm = _models(tmp_path)
    kw = dict(validationInterval=2, seed=6, ellDegree=6, probExpert=0.5,
              DAGgerType="randomEpoch")
    jlog, tlog = [], []
    jout = _recording(JT.TrainerFlocking, jlog)(jm, jd, 2, 3, **kw).train()
    ttr = _recording(TT.TrainerFlocking, tlog)(tm, td, 2, 3, **kw)
    tout = ttr.train()
    np.testing.assert_allclose(tout["lossTrain"], jout["lossTrain"], **TOL)
    np.testing.assert_allclose(tout["costValid"], jout["costValid"], **TOL)
    assert len(tlog) == len(jlog) > 0
    assert ttr.SAll.shape == (8, 8, 12, 12)
