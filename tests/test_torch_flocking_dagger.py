"""PyTorch port, the flocking training slice's DAGger over the
device-resident store, the re-rolls' lam_iters and the largeswarm example,
held against the JAX package on the CPU with the same inputs and weights
(moved from tests/test_torch_flocking_training.py, whose store and
helpers they use). Tolerance: rtol = atol = 1e-4 unless stated.
"""

import numpy as np
import pytest
import torch

from graph_neural_networks_torch import training as TT
from graph_neural_networks_torch.examples import largeswarm as tlarge
from graph_neural_networks_torch.models import architectures_time as tarcht
from graph_neural_networks_tpu import training as JT

from tests.test_torch_flocking_training import (  # noqa: F401 (a fixture)
    _models, _port_store, stores)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine: one intra-op thread
    keeps the many small torch ops here from oversubscribing its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _recording(cls, log, changed=None):
    """cls logging each DAGger selection; with `changed`, also whether the
    update changed the store's rows (the port's tensors)."""
    class Recording(cls):
        def _device_store_update(self, sel):
            log.append(np.asarray(sel).copy())
            super()._device_store_update(sel)
            if changed is not None:
                t = torch.as_tensor(np.asarray(sel))
                changed.append(bool((self.posAll[t] != self.posOrig[t])
                                    .any()))
    return Recording


@pytest.mark.parametrize("dagger,prob,epochs", [("randomEpoch", 0.5, 3),
                                                ("replaceTimeBatch", 0.9, 2)])
def test_dagger_matches_jax_selection(stores, tmp_path, dagger, prob,
                                      epochs):
    """DAGger over the device store: the learner index sets (drawn from the
    trainer's numpy rng after its batch permutations) equal the JAX
    trainer's, the store mutates where learners were re-rolled and the
    originals stay, and losses and validation costs are finite."""
    jd, _ = stores
    td = _port_store(jd, 40)
    jm, tm = _models(tmp_path)
    jlog, tlog, changed = [], [], []
    kw = dict(validationInterval=2, probExpert=prob, DAGgerType=dagger,
              deviceStore=True, ellDegree=16, seed=6, rolloutChunk=4)
    jtr = _recording(JT.TrainerFlocking, jlog)(jm, jd, epochs, 3, **kw)
    ttr = _recording(TT.TrainerFlocking, tlog, changed)(tm, td, epochs, 3,
                                                        **kw)
    jtr.train()
    out = ttr.train()
    assert len(tlog) == len(jlog) > 0
    for a, b in zip(tlog, jlog):
        np.testing.assert_array_equal(a, b)
    assert all(changed)
    assert np.isfinite(out["lossTrain"]).all()
    assert np.isfinite(out["costValid"]).all()
    assert torch.equal(ttr.posOrig, td.pos["train"])


def test_rollout_traj_device_takes_the_dataset_lam_iters(stores):
    """Re-rolls normalize their graphs as generation did: lam_iters
    defaults to the dataset's rollout_lam_iters."""
    _, td = stores
    net = tarcht.LocalGNN_DB([6, 8], [2], True, "tanh", [2], 1,
                             device="cpu",
                             generator=torch.Generator().manual_seed(1))
    ip, iv = td.getData("initPos", "valid"), td.getData("initVel", "valid")
    got = td.rollout_traj_device(ip, iv, 0.5, net)
    want = td.rollout_traj_device(ip, iv, 0.5, net, lam_iters=1)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_largeswarm_driver_trains_on_the_cpu():
    out = tlarge.main(["--device", "cpu", "--deviceStore",
                       "--trainAgents", "64",
                       "--nTrain", "2", "--nEpochs", "2", "--batch", "1",
                       "--trainDuration", "0.05", "--deployAgents", "64",
                       "--duration", "0.05"])
    assert out["device"] == "cpu" and out["train_agents"] == 64
    assert out["mode"] == "Flocking.large_device"
    for k in ("loss_first", "loss_last", "best_valid", "cost_small",
              "expert", "cost_big"):
        assert np.isfinite(out[k]), k
