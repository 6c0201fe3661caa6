"""PyTorch port, the seven task drivers of
``graph_neural_networks_torch/examples/``: each ``main(["--quick",
"--device", "cpu", "--epochs", "1"])`` returns the result keys of its JAX
counterpart in ``examples/`` with finite costs, on the datasets' synthetic
fallbacks; and each driver's models keep the JAX driver's list.
"""

import importlib
import json
import math

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine: one intra-op thread
    keeps the many small torch ops here from oversubscribing its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# The keys each JAX driver returns under --quick (examples/<task>.py: the
# model lists that --quick keeps), and its full model list.
QUICK_KEYS = {
    "movielens": ["LocalGNN1Ly"],
    "epidemic": ["GRNN", "GatedGRNN-time"],
    "sourceloc": ["SelGNNDegree", "AggGNN"],
    "authorship": ["SelGNN", "MaxLocal"],
    "twentynews": ["costBest", "costLast"],
    "variants": ["Spectral", "NodeVariant", "EdgeVariant", "ARMA", "GCAT",
                 "EVAttention", "SelGNNcoarse", "MultiNodeAgg"],
    "transfer": ["clean", "fail0.05", "fail0.15"],
}
FULL_MODELS = {
    "movielens": ["SelGNN", "LocalGNN1Ly", "LocalGNN2Ly"],
    "epidemic": ["GRNN", "GatedGRNN-time", "GatedGRNN-node",
                 "GatedGRNN-edge"],
    "sourceloc": ["SelGNNDegree", "SelGNNEDS", "SelGNNSpectralProxies",
                  "SelGNNcrs", "AggGNN"],
    "authorship": ["SelGNN", "MaxLocal", "MedianLocal"],
    "twentynews": ["SelGNN20news"],
    "variants": QUICK_KEYS["variants"],
    "transfer": ["transfer"],
}


def _costs(result):
    for v in result.values():
        if isinstance(v, dict):
            yield from _costs(v)
        else:
            yield v


@pytest.mark.parametrize("task", sorted(QUICK_KEYS))
def test_driver_quick_on_the_cpu(task, tmp_path, capsys):
    mod = importlib.import_module(
        f"graph_neural_networks_torch.examples.{task}")
    out = mod.main(["--quick", "--device", "cpu", "--epochs", "1",
                    "--saveDir", str(tmp_path)])
    assert sorted(out) == sorted(QUICK_KEYS[task])
    costs = list(_costs(out))
    assert costs and all(math.isfinite(c) for c in costs), out
    assert "== summary ==" in capsys.readouterr().out or task in (
        "twentynews", "transfer")
    assert list((tmp_path / "savedModels").glob("*Best.ckpt"))


@pytest.mark.parametrize("task", sorted(FULL_MODELS))
def test_driver_full_model_list(task):
    """setup() without --quick: the JAX driver's models in its order,
    --epochs taking the place of nEpochs, each built on the CPU."""
    mod = importlib.import_module(
        f"graph_neural_networks_torch.examples.{task}")
    t = mod.setup(mod._args(["--device", "cpu", "--epochs", "2"]))
    assert [s.name for s in t.models] == FULL_MODELS[task]
    assert t.nEpochs == 2
    if task in ("movielens", "twentynews", "authorship", "transfer"):
        for spec in t.models:
            assert spec.build("cpu").parameter_count() > 0


def test_sourceloc_config_path(tmp_path):
    """--config: a typed ExperimentConfig JSON sets the graph and the
    widths; the effective config is written next to the outputs and loads
    back."""
    from graph_neural_networks_torch.examples import sourceloc
    from graph_neural_networks_torch.utils.config import ExperimentConfig
    cfg = {"name": "sl", "graph": {"graphType": "SBM", "nNodes": 30,
                                   "options": {"nCommunities": 3}},
           "model": {"architecture": "SelectionGNN", "kwargs": {
               "dimNodeSignals": [1, 4, 4], "nFilterTaps": [2, 2],
               "nSelectedNodes": [10, 5], "dimLayersMLP": [3]}},
           "training": {"nEpochs": 3, "batchSize": 25}}
    (tmp_path / "in.json").write_text(json.dumps(cfg))
    out_dir = tmp_path / "out"
    args = sourceloc._args(["--quick", "--device", "cpu", "--config",
                            str(tmp_path / "in.json")])
    t = sourceloc.setup(args, str(out_dir))
    assert t.nEpochs == 3 and t.batch == 25
    arch = t.models[0].build("cpu")
    assert arch.N == [30, 10, 5]
    written = ExperimentConfig.load(str(out_dir / "config.json"))
    assert written.graph.nNodes == 30
    assert written.model.kwargs["nFilterTaps"] == [2, 2]
    assert (out_dir / "hyperparameters.txt").exists()
    y = arch.apply(t.data.getSamples("test")[0][:2])
    assert tuple(y.shape) == (2, 3) and bool(torch.isfinite(y).all())
    assert np.isfinite(t.data.samples["train"]["signals"]).all()
