"""PyTorch port, the task utilities against the JAX package's: the graph
helpers (degree normalizations, ``sparsify_graph``, ``edge_fail_sampling``,
``Graph.compute_gft``/``set_gso``) and ``data/base.py``'s helpers exactly;
``num2filename`` and the seed round trip; the typed configs (a JSON
written by the JAX package loads here and writes back the same JSON) and
the two architecture registries; the Visualizer's JSONL and JSON; the
profiling helpers; ``Flocking.comm_graph_ell``, ``saveVideo`` and
``evaluate_flocking(nVideos=...)``.
"""

import json
import sys

import numpy as np
import pytest
import torch

from graph_neural_networks_torch import training as ttrain
from graph_neural_networks_torch.data import base as tbase
from graph_neural_networks_torch.data import flocking as tF
from graph_neural_networks_torch.models import architectures as tarch
from graph_neural_networks_torch.models import architectures_time as tat
from graph_neural_networks_torch.utils import config as tcfg
from graph_neural_networks_torch.utils import graph as tgt
from graph_neural_networks_torch.utils import misc as tmisc
from graph_neural_networks_torch.utils import visual as tvis
from graph_neural_networks_tpu.data import base as jbase
from graph_neural_networks_tpu.data import flocking as jF
from graph_neural_networks_tpu.utils import config as jcfg
from graph_neural_networks_tpu.utils import graph as jgt
from graph_neural_networks_tpu.utils import misc as jmisc
from graph_neural_networks_tpu.utils import visual as jvis

SBM = {"nCommunities": 3, "probIntra": 0.6, "probInter": 0.1}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine: one intra-op thread
    keeps the many small torch ops here from oversubscribing its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- graph and data helpers --------------------------------------------------

def _sbm(N=24, seed=1):
    return tgt.Graph("SBM", N, SBM, rng=np.random.default_rng(seed)).W


def test_normalizations_equal_jax():
    W = _sbm()
    assert np.array_equal(tgt.normalize_adjacency(W),
                          jgt.normalize_adjacency(W))
    L = tgt.adjacency_to_laplacian(W)
    assert np.array_equal(tgt.normalize_laplacian(L),
                          jgt.normalize_laplacian(L))


@pytest.mark.parametrize("kind,p", [("threshold", 0.9), ("NN", 1),
                                    ("NN", 3)])
def test_sparsify_graph_equals_jax(kind, p):
    """A weighted connected graph: the threshold halves and the kNN count
    grows until the sparsified graph is connected again."""
    rng = np.random.default_rng(2)
    W = _sbm() * rng.random((24, 24))
    W = (W + W.T) / 2
    got = tgt.sparsify_graph(W, kind, p)
    assert np.array_equal(got, jgt.sparsify_graph(W, kind, p))
    assert tgt.is_connected(got)
    Wd = W * (rng.random(W.shape) < 0.7)           # directed
    assert np.array_equal(tgt.sparsify_graph(Wd, kind, p),
                          jgt.sparsify_graph(Wd, kind, p))


@pytest.mark.parametrize("directed", [False, True])
def test_edge_fail_sampling_equals_jax(directed):
    W = _sbm()
    if directed:
        W = W * (np.random.default_rng(3).random(W.shape) < 0.6)
    got = tgt.edge_fail_sampling(W, 0.3, rng=np.random.default_rng(4))
    assert np.array_equal(
        got, jgt.edge_fail_sampling(W, 0.3, rng=np.random.default_rng(4)))
    if not directed:
        assert np.array_equal(got, got.T)
    with pytest.raises(ValueError):
        tgt.edge_fail_sampling(W, 1.5)


def test_graph_gft_and_set_gso_equal_jax():
    tG = tgt.Graph("SBM", 20, SBM, rng=np.random.default_rng(5))
    jG = jgt.Graph("SBM", 20, SBM, rng=np.random.default_rng(5))
    assert tG.E is None and tG.V is None
    tG.compute_gft()
    jG.compute_gft()
    assert np.array_equal(tG.E, jG.E) and np.array_equal(tG.V, jG.V)
    L = tG.L
    for gft in ("increasing", "totalVariation", "no"):
        tG.set_gso(L, gft)
        jG.set_gso(L, gft)
        assert tG.S is L
        for a, b in ((tG.E, jG.E), (tG.V, jG.V)):
            assert (a is None and b is None) or np.array_equal(a, b)
    with pytest.raises(ValueError):
        tG.set_gso(L[:5, :5])


@pytest.mark.parametrize("N,C,seed", [(100, 5, 0), (40, 4, 1), (60, 4, 2),
                                      (234, 2, 3)])
def test_spectral_clustering_equals_sklearn_without_it(N, C, seed,
                                                       monkeypatch):
    """The source nodes of the source-localization task: the port's
    numpy/scipy spectral clustering gives scikit-learn's labels (the JAX
    package's compute_source_nodes calls scikit-learn) and runs where
    scikit-learn is missing, as on the card's machine."""
    from sklearn.cluster import SpectralClustering
    A = tgt.Graph("SBM", N, {"nCommunities": C, "probIntra": 0.8 if N < 200
                             else 0.15, "probInter": 0.2 if N < 200
                             else 0.01}, rng=np.random.default_rng(seed)).A
    want = SpectralClustering(n_clusters=C, affinity="precomputed",
                              assign_labels="discretize",
                              random_state=seed).fit(A).labels_
    sources = jgt.compute_source_nodes(A, C, seed)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    assert np.array_equal(tgt.spectral_clustering(A, C, seed), want)
    assert tgt.compute_source_nodes(A, C, seed) == sources


def test_plot_and_print_graph(tmp_path):
    W = _sbm(12)
    fig = tgt.plot_graph(W, save_to=str(tmp_path / "g.png"))
    assert (tmp_path / "g.png").stat().st_size > 0 and fig is not None
    tgt.print_graph(W, save_to=str(tmp_path / "a.png"))
    assert (tmp_path / "a.png").exists()


def test_data_helpers_equal_jax():
    x = np.random.default_rng(6).standard_normal((7, 3, 5))
    x[:, 1] = 2.0                                     # zero variance
    for ax in (0, 1, 2):
        assert np.array_equal(tbase.normalize_data(x, ax),
                              jbase.normalize_data(x, ax))
    for dtype in (np.float32, np.int64):
        a = tbase.change_data_type(x, dtype)
        assert a.dtype == dtype
        assert np.array_equal(a, jbase.change_data_type(x, dtype))
    assert tbase.change_data_type(None, np.float32) is None


# -- misc --------------------------------------------------------------------

@pytest.mark.parametrize("x", [3, 3.0, 0.25, 1e-3, -2.5])
def test_num2filename_equals_jax(x):
    assert tmisc.num2filename(x) == jmisc.num2filename(x)
    assert tmisc.num2filename(x, "_") == jmisc.num2filename(x, "_")


def test_seed_round_trip(tmp_path):
    """The numpy Generator and the torch Generator resume where they were
    saved."""
    rng = np.random.default_rng(7)
    rng.random(3)
    gen = torch.Generator().manual_seed(8)
    torch.randn(4, generator=gen)
    path = tmisc.save_seed(str(tmp_path), numpy_rng=rng,
                           torch_generator=gen)
    assert path.endswith("randomSeedUsed.pkl")
    want_np, want_t = rng.random(5), torch.randn(5, generator=gen)
    rng2, gen2 = tmisc.load_seed(str(tmp_path))
    assert np.array_equal(rng2.random(5), want_np)
    assert torch.equal(torch.randn(5, generator=gen2), want_t)
    tmisc.save_seed(str(tmp_path), numpy_rng=rng, filename="np.pkl")
    assert tmisc.load_seed(str(tmp_path), "np.pkl")[1] is None
    # the JAX package reads the numpy half of the same file
    jrng, _ = jmisc.load_seed(str(tmp_path), "np.pkl")
    assert np.array_equal(jrng.random(2), rng.random(2))


# -- configs and the registry ------------------------------------------------

def _experiment(mod):
    return mod.ExperimentConfig(
        name="sourceloc", seed=3, saveDir="out",
        graph=mod.GraphConfig(graphType="SBM", nNodes=30,
                              options={"nCommunities": 3}),
        model=mod.ModelConfig(architecture="SelectionGNN", kwargs={
            "dimNodeSignals": [1, 4], "nFilterTaps": [2], "bias": True,
            "nonlinearity": "relu", "nSelectedNodes": [30],
            "poolingFunction": "NoPool", "poolingSize": [1],
            "dimLayersMLP": [3]}),
        training=mod.TrainingConfig(nEpochs=5, batchSize=8, lr=2e-3,
                                    learningRateDecayRate=0.5,
                                    learningRateDecayPeriod=2))


def test_config_json_round_trip_with_jax(tmp_path):
    """A config the JAX package writes loads here and writes back the same
    JSON (and the reverse); the typed checks raise at load."""
    jpath, tpath = tmp_path / "j.json", tmp_path / "t.json"
    _experiment(jcfg).save(str(jpath))
    cfg = tcfg.ExperimentConfig.load(str(jpath))
    assert isinstance(cfg.model, tcfg.ModelConfig)
    assert cfg.training.learningRateDecayPeriod == 2
    cfg.save(str(tpath))
    assert tpath.read_text() == jpath.read_text()
    assert jcfg.ExperimentConfig.load(str(tpath)).to_dict() == cfg.to_dict()
    assert cfg.training.optimizer_spec() == \
        _experiment(jcfg).training.optimizer_spec()
    bad = json.loads(jpath.read_text())
    bad["training"]["nEpochs"] = "five"
    with pytest.raises(TypeError):
        tcfg.ExperimentConfig.from_dict(bad)
    bad = json.loads(jpath.read_text())
    bad["graph"]["nodes"] = 3
    with pytest.raises(ValueError):
        tcfg.ExperimentConfig.from_dict(bad)
    # float fields take ints
    assert tcfg.TrainingConfig.from_dict({"lr": 1}).lr == 1.0


def test_model_config_builds_the_port_architecture():
    cfg = _experiment(tcfg)
    S = _sbm(30)
    S = S / np.max(np.abs(np.linalg.eigvalsh(S)))
    arch = cfg.model.build(S, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    assert isinstance(arch, tarch.SelectionGNN)
    assert tuple(arch.apply(np.ones((2, 1, 30))).shape) == (2, 3)
    optimizer = ttrain.make_optimizer(cfg.training.optimizer_spec(),
                                      arch.parameters())
    assert optimizer.param_groups[0]["lr"] == 2e-3


def test_registries_list_the_same_names():
    """Every class in the __all__ of the two architecture modules, as
    JAX's registry (TorchDense and MLP included)."""
    names = tcfg.list_architectures()
    assert names == jcfg.list_architectures()
    assert {"TorchDense", "MLP", "LocalGNN_DB"} <= set(names)
    assert tcfg.get_architecture("LocalGNN") is tarch.LocalGNN
    assert tcfg.get_architecture("GraphRecurrentNN_DB") is \
        tat.GraphRecurrentNN_DB
    with pytest.raises(KeyError):
        tcfg.get_architecture("NoSuchGNN")

    @tcfg.register_architecture(name="Custom_test_arch")
    class Custom:
        pass
    assert tcfg.get_architecture("Custom_test_arch") is Custom
    tcfg._ARCHITECTURES.pop("Custom_test_arch")


# -- the logger and the profiling helpers ------------------------------------

def _log(mod, d):
    v = mod.Visualizer(str(d), name="run")
    v.scalar_summary("Training", 0, lossTrain=1.5)
    v.scalar_summary("Validation", 3, costValid=np.float32(0.25),
                     accuracy=1)
    v.histogram_summary("w", np.arange(6.0), epoch=2)
    v.text_summary("note", "hello")
    return v


def test_visualizer_writes_what_jax_writes(tmp_path):
    tv, jv = _log(tvis, tmp_path / "t"), _log(jvis, tmp_path / "j")
    assert (tmp_path / "t" / "run.jsonl").read_text() == \
        (tmp_path / "j" / "run.jsonl").read_text()
    assert open(tv.export_json()).read() == open(jv.export_json()).read()
    # a tensor histogram logs as its numpy array would
    tv.histogram_summary("t", torch.arange(6.0), epoch=2)
    lines = (tmp_path / "t" / "run.jsonl").read_text().splitlines()
    assert json.loads(lines[-1])["mean"] == json.loads(lines[2])["mean"]
    import matplotlib.pyplot as plt
    fig = plt.figure()
    assert tv.figure_summary("f", fig).endswith("run_f.png")
    plt.close(fig)


def test_profiling_helpers(tmp_path):
    with tvis.profile_trace(str(tmp_path)):
        torch.ones(8).sum()
    assert json.loads((tmp_path / "trace.json").read_text())
    assert tvis.timed(torch.ones, 4, iters=2, warmup=1) > 0
    assert tvis.edges_per_second(10, 4, 3, 2.0) == \
        jvis.edges_per_second(10, 4, 3, 2.0) == 60.0
    tvis.enable_nan_debugging(True)
    try:
        assert torch.is_anomaly_enabled()
    finally:
        tvis.enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()


# -- flocking: the ELL graphs, the videos ------------------------------------

FLOCK = dict(nAgents=8, commRadius=2.0, repelDist=1.0, nTrain=3, nValid=1,
             nTest=2, duration=0.5, samplingTime=0.1)


@pytest.fixture(scope="module")
def flock():
    return (jF.Flocking(rng=np.random.default_rng(3), **FLOCK),
            tF.Flocking(rng=np.random.default_rng(3), device="cpu", **FLOCK))


@pytest.mark.parametrize("d_max", [None, 3])
def test_comm_graph_ell_matches_jax(flock, d_max):
    jd, td = flock
    got, want = td.comm_graph_ell("train", d_max), jd.comm_graph_ell(
        "train", d_max)
    assert np.array_equal(got.idx.numpy(), np.asarray(want.idx))
    # the store's f64 values, which the JAX EllGso holds in f32
    assert got.val.dtype == torch.float64
    assert np.array_equal(got.val.numpy().astype(np.float32),
                          np.asarray(want.val))
    assert tuple(got.idx.shape[:3]) == (3, 5, 8)


def _flock_model(td, tmp_path):
    arch = tat.LocalGNN_DB([6, 4], [2], True, "tanh", [2], 1, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    model = ttrain.Model(arch, ttrain.losses.mse_loss,
                         {"name": "ADAM", "lr": 1e-3}, ttrain.TrainerFlocking,
                         ttrain.evaluate_flocking, name="flt",
                         saveDir=str(tmp_path))
    model.save("Best")
    model.save("Last")
    return model


def test_evaluate_flocking_saves_videos(flock, tmp_path, monkeypatch):
    """nVideos=1 writes the first test trajectory's frames for each
    checkpoint; without matplotlib it returns the same costs and writes
    none, as the JAX evaluator."""
    _, td = flock
    model = _flock_model(td, tmp_path)
    res = ttrain.evaluate_flocking(model, td, nVideos=1)
    assert sorted(res) == ["costBestEnd", "costBestFull", "costLastEnd",
                           "costLastFull"]
    for label in ("Best", "Last"):
        frames = sorted((tmp_path / f"videos{label}").glob("frame*.png"))
        assert len(frames) == 5                     # T = 5, one a step
    assert res == ttrain.evaluate_flocking(model, td)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert td.saveVideo(str(tmp_path / "none"),
                        td.getData("pos", "test")) is None
    res2 = ttrain.evaluate_flocking(_flock_model(td, tmp_path / "m"), td,
                                    nVideos=1)
    assert res2 == res
    assert not list((tmp_path / "m" / "videosBest").glob("*.png"))
