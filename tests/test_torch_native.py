"""PyTorch port, the native graph-structure binding (``utils/native.py``,
ROADMAP item 9): the library built from the port's own copy of the source
(``kernels/csrc/graphcore.cpp``) with the host compiler, never the JAX
package's ``native/libgraphcore.so``; a failed build raises; and what it
builds, bit-equal to the port's numpy plain versions (``GNT_NO_NATIVE``)
and to the JAX package's layouts, neighborhoods and Graclus coarsening.
"""

import os

import numpy as np
import pytest
import scipy.sparse
import torch

from graph_neural_networks_torch import kernels
from graph_neural_networks_torch.ops import spmm as tspmm
from graph_neural_networks_torch.utils import graph as tgt
from graph_neural_networks_torch.utils import native
from graph_neural_networks_tpu.ops import spmm as jspmm
from graph_neural_networks_tpu.utils import graph as jgt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine: one intra-op thread
    keeps the many small torch ops here from oversubscribing its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(monkeypatch, fn):
    """fn() through the native library, then through the numpy plain
    versions (GNT_NO_NATIVE set)."""
    monkeypatch.delenv("GNT_NO_NATIVE", raising=False)
    got = fn()
    monkeypatch.setenv("GNT_NO_NATIVE", "1")
    want = fn()
    monkeypatch.delenv("GNT_NO_NATIVE")
    return got, want


def _equal(a, b) -> bool:
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == np.asarray(b).dtype and np.array_equal(a, b)
    return a == b


def test_builds_from_the_ports_source():
    """The library is the port's build of its own copy of the source, under
    kernels/build/, and the loaded one; the JAX package's is never used."""
    path, _ = native.build()
    assert os.path.dirname(os.path.dirname(path)) == kernels.BUILD_ROOT
    assert native.SOURCE == os.path.join(
        REPO, "graph_neural_networks_torch", "kernels", "csrc",
        "graphcore.cpp")
    assert native.library()._name == path
    assert not path.startswith(os.path.join(REPO, "native"))
    assert "-march=native" not in native.CXX_FLAGS


@pytest.mark.parametrize("compiler", ["/nonexistent/g++", "false"])
def test_failed_build_raises(compiler):
    """A compiler that does not exist, or one that fails, raises with the
    command; no library directory is left behind."""
    with pytest.raises(RuntimeError, match="graphcore build failed"):
        native.build(compiler=compiler)
    assert not os.path.exists(native._build_dir(compiler))


def _banded(rng, N, half, per_row=5):
    S = np.zeros((N, N))
    for i in range(N):
        js = np.clip(i + rng.integers(-half, half + 1, per_row), 0, N - 1)
        S[i, js] = rng.standard_normal(len(js))
    return S


LAYOUT_CASES = [  # (N, bs, half-bandwidth): ragged N = 1001 at bs 128
    (1001, 128, 150), (96, 16, 20), (64, 16, 0), (200, 64, 0)]


@pytest.mark.parametrize("N,bs,half", LAYOUT_CASES,
                         ids=[f"N{n}-bs{b}-h{h}" for n, b, h in LAYOUT_CASES])
def test_layouts_bit_equal(monkeypatch, N, bs, half):
    """dense_to_bcsr, dense_to_band and dense_to_band_at natively, in
    numpy and in the JAX package (its own native path and its numpy one),
    element for element and dtype for dtype; (200, 64, 0) is an all-zero
    S, whose BCSR layout keeps one zero block."""
    rng = np.random.default_rng(N + half)
    S = np.zeros((N, N)) if N == 200 else _banded(rng, N, half)

    def layouts(mod):
        band, w = mod.dense_to_band(S, bs)
        return (mod.dense_to_bcsr(S, bs), band, w,
                mod.dense_to_band_at(S, bs, w + 1))
    got, plain = _both(monkeypatch, lambda: layouts(tspmm))
    jax_native, jax_plain = _both(monkeypatch, lambda: layouts(jspmm))
    for other in (plain, jax_native, jax_plain):
        assert _equal(got, other)
    if N == 200:
        blocks, rows, cols = got[0]
        assert blocks.shape == (1, bs, bs) and not blocks.any()
        assert rows.tolist() == cols.tolist() == [0]
        assert got[2] == 0


def test_entry_points_match_their_numpy_versions():
    """The binding's own returns: band_extract's block bandwidth and slab,
    bcsr_count and bcsr_extract's sorted tiles."""
    rng = np.random.default_rng(3)
    S = _banded(rng, 300, 70).astype(np.float32)
    slab, w = native.band_extract(S, 32, 0)
    _, w_np = tspmm.dense_to_band(S, 32)
    assert w == w_np and slab.shape == (10, 32, 32)
    slab, bw = native.band_extract(S, 32, w)
    assert bw == w and np.array_equal(slab, tspmm.dense_to_band_at(S, 32, w))
    blocks, rows, cols = native.bcsr_extract(S, 32)
    assert native.bcsr_count(S, 32) == blocks.shape[0]
    assert native.bcsr_count(np.zeros((40, 40), np.float32), 16) == 1
    order = np.lexsort((rows, cols))
    assert np.array_equal(order, np.arange(len(rows)))


@pytest.fixture(scope="module")
def W():
    return jgt.create_graph("SBM", 60, {"nCommunities": 4, "probIntra": 0.6,
                                        "probInter": 0.08},
                            rng=np.random.default_rng(1))


@pytest.mark.parametrize("K", [1, 2, 3])
def test_bfs_khop_bit_equal(monkeypatch, W, K):
    """compute_neighborhood's lists and self-padded tables, all rows and a
    cut (n_rows = 20, nb = 30), natively, in numpy and in the JAX
    package."""
    for kw in ({}, {"n_rows": 20, "nb": 30}):
        def both_types(mod):
            return (mod.compute_neighborhood(W, K, output_type="list", **kw),
                    mod.compute_neighborhood(W, K, output_type="matrix",
                                             **kw))
        got, plain = _both(monkeypatch, lambda: both_types(tgt))
        jax_native, jax_plain = _both(monkeypatch, lambda: both_types(jgt))
        for other in (plain, jax_native, jax_plain):
            assert _equal(got, other), kw


@pytest.mark.parametrize("levels", [1, 3])
def test_graclus_bit_equal(monkeypatch, W, levels):
    """The multilevel matching's cluster ids and the coarsened graphs and
    order, natively, in numpy and in the JAX package, from one seed."""
    def coarsened(mod):
        graphs, order = mod.coarsen(scipy.sparse.csr_matrix(W), levels,
                                    rng=np.random.default_rng(4))
        return [g.toarray() for g in graphs], list(map(int, order))
    got, plain = _both(monkeypatch, lambda: coarsened(tgt))
    jax_native, jax_plain = _both(monkeypatch, lambda: coarsened(jgt))
    for other in (plain, jax_native, jax_plain):
        assert _equal(got, other)
    parents = _both(monkeypatch, lambda: tgt._multilevel_matching(
        W, levels, np.random.default_rng(5))[1])
    assert _equal(*parents)
