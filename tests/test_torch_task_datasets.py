"""PyTorch port, the task datasets (``data/datasets.py``): Epidemics,
MovieLens, Authorship, TwentyNews, FacebookEgo and the word-graph helpers
against the JAX package's on the same numpy seeds, bit for bit (the same
numpy calls in the same order), at small sizes; each ``data_dir`` loader
on a small file the test writes.
"""

import os
import pickle

import numpy as np
import pytest
import scipy.io
import torch

from graph_neural_networks_torch import data as tdata
from graph_neural_networks_torch.data import datasets as tds
from graph_neural_networks_tpu import data as jdata
from graph_neural_networks_tpu.data import datasets as jds


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine: one intra-op thread
    keeps the many small torch ops here from oversubscribing its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_samples(t, j):
    for split in ("train", "valid", "test"):
        for key in ("signals", "targets"):
            a, b = t.samples[split][key], j.samples[split][key]
            assert a.dtype == b.dtype, (split, key)
            assert np.array_equal(a, b), (split, key)
    assert (t.nTrain, t.nValid, t.nTest) == (j.nTrain, j.nValid, j.nTest)


# -- Epidemics ---------------------------------------------------------------

def _epidemics(mod, data_dir=None, seed=0, seed_prob=0.02):
    return mod.Epidemics(3, seed_prob, 0.3, 2, 12, 4, 5, data_dir=data_dir,
                         rng=np.random.default_rng(seed))


@pytest.mark.parametrize("seed", [0, 3])
def test_epidemics_synthetic_equals_jax(seed):
    """The SBM fallback (120 nodes), the x0 rejection loop (seedProb 0.02
    redraws: some sample seeds no infection) and the SIR run draw in JAX's
    order."""
    t, j = _epidemics(tds, seed=seed), _epidemics(jds, seed=seed)
    assert np.array_equal(t.Adj, j.Adj) and t.N == j.N == 120
    assert np.array_equal(t.x0, j.x0)
    assert (t.x0.sum(axis=1) > 0).all()
    _same_samples(t, j)
    x = t.samples["train"]["signals"]
    assert x.shape == (12, 3, 120) and set(np.unique(x)) <= {0.0, 1.0, 2.0}
    t.expandDims()
    assert t.samples["train"]["signals"].shape == (12, 3, 1, 120)


def test_epidemics_edge_list_loader_equals_jax(tmp_path):
    """SocioPatterns' tab-separated, 1-indexed edge list: symmetrized,
    isolated ids dropped (node 6 never appears)."""
    edges = [(1, 2), (2, 3), (3, 1), (4, 5), (5, 7), (7, 1), (2, 8), (8, 4)]
    d = tmp_path / "epidemics"
    d.mkdir()
    (d / "edge_list.txt").write_text(
        "".join(f"{i}\t{j}\n" for i, j in edges))
    t = _epidemics(tds, str(tmp_path), seed_prob=0.3)
    j = _epidemics(jds, str(tmp_path), seed_prob=0.3)
    assert t.Adj.shape == (7, 7)
    assert np.array_equal(t.Adj, j.Adj) and np.array_equal(t.Adj, t.Adj.T)
    _same_samples(t, j)


def test_epidemics_evaluate_equals_jax():
    rng = np.random.default_rng(5)
    t = _epidemics(tds)
    yHat = rng.standard_normal((4, 3, 2, 120))
    y = (rng.random((4, 3, 120)) < 0.3).astype(np.int64)
    y[0] = 0                       # no positives: the reference NaN guards
    yHat[0, :, 0] = 5.0
    assert t.evaluate(yHat, y) == _epidemics(jds).evaluate(yHat, y)


# -- MovieLens ---------------------------------------------------------------

ML = dict(kNN=4, nSynthUsers=60, nSynthMovies=40)


def _movielens(mod, lid, seed=0, **kw):
    return mod.MovieLens("movie", lid, 0.8, 0.2,
                         rng=np.random.default_rng(seed), **{**ML, **kw})


def _same_movielens(t, j):
    _same_samples(t, j)
    assert np.array_equal(t.adjacencyMatrix, j.adjacencyMatrix)
    assert np.array_equal(t.incompleteMatrix, j.incompleteMatrix)
    assert t.nodeList == j.nodeList and t.labelID == j.labelID
    for split in ("train", "valid", "test"):
        assert np.array_equal(t.getLabelID(split), j.getLabelID(split))
        assert np.array_equal(t.indexDataPoints[split],
                              j.indexDataPoints[split])


def test_movielens_synthetic_equals_jax():
    """A movie graph that drops nodes (in-degree 0 before symmetrizing):
    the label id and the per-sample target ids are remapped alike."""
    t, j = _movielens(tds, 7), _movielens(jds, 7)
    _same_movielens(t, j)
    N = t.adjacencyMatrix.shape[0]
    assert N < 40 and len(t.nodeList) == N
    assert t.labelID == [t.nodeList.index(7)]
    assert t.samples["train"]["signals"].shape[1] == N
    assert (t.getLabelID("train") == t.labelID[0]).all()
    idx = np.array([2, 0])
    assert np.array_equal(t.getLabelID("train", idx),
                          j.getLabelID("train", idx))
    assert t.getLabelID() == j.getLabelID()
    y = t.samples["test"]["targets"]
    yHat = y + np.random.default_rng(1).standard_normal(y.shape)
    assert t.evaluate(yHat[:, None], y) == j.evaluate(yHat[:, None], y)


def test_movielens_options_and_interpolation_equal_jax():
    """The user graph, minRatings and maxNodes cuts, a kept-isolated
    graph, and the nearest-neighbour rating interpolation."""
    kw = dict(minRatings=3, maxNodes=45, keepIsolatedNodes=True)
    t = tds.MovieLens("user", 4, 0.8, 0.2, rng=np.random.default_rng(2),
                      **{**ML, **kw})
    j = jds.MovieLens("user", 4, 0.8, 0.2, rng=np.random.default_rng(2),
                      **{**ML, **kw})
    _same_movielens(t, j)
    t.expandDims()
    j.expandDims()
    t.interpolateRatings()
    j.interpolateRatings()
    _same_samples(t, j)


def test_movielens_u_data_loader_equals_jax(tmp_path):
    """ml-100k's u.data (user, item, rating, timestamp; 1-indexed) from
    data_dir/ml-100k."""
    rng = np.random.default_rng(4)
    rows = {(int(u), int(m)) for u, m in zip(rng.integers(1, 31, 300),
                                             rng.integers(1, 21, 300))}
    d = tmp_path / "ml-100k"
    d.mkdir()
    (d / "u.data").write_text("".join(
        f"{u}\t{m}\t{rng.integers(1, 6)}\t{881250949 + k}\n"
        for k, (u, m) in enumerate(sorted(rows))))
    kw = dict(data_dir=str(tmp_path), kNN=3)
    t = tds.MovieLens("movie", 2, 0.8, 0.2, rng=np.random.default_rng(0),
                      **kw)
    j = jds.MovieLens("movie", 2, 0.8, 0.2, rng=np.random.default_rng(0),
                      **kw)
    assert t.incompleteMatrix.shape == (30, 20)
    _same_movielens(t, j)


# -- Authorship --------------------------------------------------------------

def _authorship(mod, data_dir=None, seed=0):
    return mod.Authorship("poe", 0.8, 0.1, data_dir=data_dir,
                          rng=np.random.default_rng(seed), nWords=20,
                          nExcerpts=12, nSynthAuthors=3)


def _same_authorship(t, j):
    _same_samples(t, j)
    assert np.array_equal(t._train_indices, j._train_indices)
    Wt, Wj = t.createGraph(), j.createGraph()
    assert np.array_equal(Wt, Wj) and t.nodeList == j.nodeList
    _same_samples(t, j)          # restricted to the graph's nodes
    assert t.samples["train"]["signals"].shape[-1] == Wt.shape[0]


def test_authorship_synthetic_equals_jax():
    _same_authorship(_authorship(tds), _authorship(jds))


def test_authorship_mat_loader_equals_jax(tmp_path):
    """authorshipData.mat in the reference's layout (MATLAB v5 cells:
    all_authors, all_freqs 1 x nWords x nData, all_wans nWords x nWords x
    nData, function_words), read by scipy.io."""
    rng = np.random.default_rng(6)
    names = ["poe", "twain", "austen"]
    nW = 15
    authors = np.empty((1, 3), dtype=object)
    freqs = np.empty((1, 3), dtype=object)
    wans = np.empty((1, 3), dtype=object)
    for i, name in enumerate(names):
        nd = 8 + i
        wan = rng.random((nW, nW, nd)) * (rng.random((nW, nW, 1)) < 0.3)
        authors[0, i] = name
        freqs[0, i] = wan.sum(axis=1)[None]       # 1 x nWords x nData
        wans[0, i] = wan
    words = np.empty((1, nW), dtype=object)
    for k in range(nW):
        words[0, k] = f"w{k}"
    path = tmp_path / "authorshipData.mat"
    scipy.io.savemat(str(path), {"all_authors": authors, "all_freqs": freqs,
                                 "all_wans": wans, "function_words": words})
    t, j = _authorship(tds, str(tmp_path)), _authorship(jds, str(tmp_path))
    assert t.functionWords == j.functionWords == [f"w{k}" for k in range(nW)]
    assert sorted(t.authorData) == sorted(names)
    assert t.nTrain + t.nValid + t.nTest == 16
    _same_authorship(t, j)


# -- TwentyNews, FacebookEgo, word-graph helpers -----------------------------

def test_twentynews_synthetic_and_npz_equal_jax(tmp_path):
    kw = dict(nWords=25, nClasses=3, nPerClass=10)
    t = tds.TwentyNews(0.1, rng=np.random.default_rng(1), **kw)
    j = jds.TwentyNews(0.1, rng=np.random.default_rng(1), **kw)
    _same_samples(t, j)
    assert np.array_equal(t.getGraph(), j.getGraph())
    rng = np.random.default_rng(2)
    np.savez(tmp_path / "twentynews.npz", x_train=rng.random((20, 9)),
             y_train=rng.integers(0, 3, 20), x_test=rng.random((6, 9)),
             y_test=rng.integers(0, 3, 6), adjacency=rng.random((9, 9)))
    t = tds.TwentyNews(0.2, data_dir=str(tmp_path))
    j = jds.TwentyNews(0.2, data_dir=str(tmp_path))
    _same_samples(t, j)
    assert (t.nTrain, t.nValid, t.nTest) == (16, 4, 6)
    assert np.array_equal(t.getGraph(), j.getGraph())


def test_facebook_ego_fallback_and_pickle_equal_jax(tmp_path):
    assert np.array_equal(tds.FacebookEgo().getAdjacencyMatrix(),
                          jds.FacebookEgo().getAdjacencyMatrix())
    A = (np.random.default_rng(3).random((12, 12)) < 0.3).astype(float)
    d = tmp_path / "facebookEgo"
    d.mkdir()
    with open(d / "facebookEgo234.pkl", "wb") as f:
        pickle.dump({"adjacencyMatrix": A}, f)
    t = tds.FacebookEgo(data_dir=str(tmp_path))
    assert np.array_equal(t.get_adjacency_matrix(), A)
    assert np.array_equal(
        t.adjacencyMatrix,
        jds.FacebookEgo(data_dir=str(tmp_path)).adjacencyMatrix)


def test_word_graph_helpers_equal_jax():
    rng = np.random.default_rng(7)
    z = rng.standard_normal((14, 5))
    dt, it = tds.distance_sklearn_metrics(z, k=3)
    dj, ij = jds.distance_sklearn_metrics(z, k=3)
    assert np.array_equal(dt, dj) and np.array_equal(it, ij)
    W = tds.knn_adjacency(dt, it)
    assert np.array_equal(W, jds.knn_adjacency(dj, ij))
    A = (W > 0).astype(float)
    assert np.array_equal(
        tds.replace_random_edges(A, 0.3, rng=np.random.default_rng(8)),
        jds.replace_random_edges(A, 0.3, rng=np.random.default_rng(8)))


def test_exports_and_no_optional_imports():
    """The datasets are exported from data/, and importing the data layer
    imports neither sklearn nor matplotlib nor h5py (the card machine has
    no sklearn and no matplotlib)."""
    import subprocess
    import sys
    for name in ("Epidemics", "MovieLens", "Authorship", "TwentyNews",
                 "FacebookEgo", "normalize_data", "change_data_type"):
        assert getattr(tdata, name) is not None
        assert hasattr(jdata, name)
    code = ("import sys; import graph_neural_networks_torch.data, "
            "graph_neural_networks_torch.training, "
            "graph_neural_networks_torch.utils.config, "
            "graph_neural_networks_torch.utils.visual; "
            "print(sorted(m for m in ('sklearn', 'matplotlib', 'h5py', "
            "'jax') if m in sys.modules))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=root, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
