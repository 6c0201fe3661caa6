"""PyTorch port: lsigf, GraphFilter, SelectionGNN, LocalGNN and the
InferenceEngine, held against the JAX package on the CPU with the same
weights (carried across by load_flax_params). The JAX band/bcsr paths run
their Pallas kernels in TPU interpret mode.

Tolerance atol = rtol = 1e-4: two filter layers of f32 sums in another
order, then the MLP readout over F*N features.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze
from jax.experimental.pallas import tpu as pltpu

from graph_neural_networks_torch import serving as tserving
from graph_neural_networks_torch.models import architectures as tarch
from graph_neural_networks_torch.models import layers as tlayers
from graph_neural_networks_torch.ops import filters as tfilters
from graph_neural_networks_torch.ops import gso as tgso
from graph_neural_networks_torch.utils.params import load_flax_params
from graph_neural_networks_tpu import serving as jserving
from graph_neural_networks_tpu.models import architectures as jarch
from graph_neural_networks_tpu.models import layers as jlayers
from graph_neural_networks_tpu.ops import filters as jfilters
from graph_neural_networks_tpu.ops import gso as jgso
from graph_neural_networks_tpu.utils import graph as jgt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine: one intra-op thread
    keeps the many small torch ops here from oversubscribing its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(atol=1e-4, rtol=1e-4)


def _banded(rng, N, half, per_row=4):
    W = np.zeros((N, N))
    for i in range(N):
        js = np.clip(i + rng.integers(-half, half + 1, per_row), 0, N - 1)
        W[i, js] = rng.random(len(js))
    W = (W + W.T) / 2
    np.fill_diagonal(W, 0)
    return W / np.max(np.abs(np.linalg.eigvalsh(W)))


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, unfreeze(params))


def _pair(cls_j, cls_t, args, kwargs_j=None, kwargs_t=None, seed=0):
    """The JAX architecture, its params, and the torch one with them."""
    with pltpu.force_tpu_interpret_mode():
        ja = cls_j(*args, **(kwargs_j or {}))
        params = ja.init(jax.random.PRNGKey(seed))
    ta = cls_t(*args, device="cpu", **(kwargs_t or {}))
    load_flax_params(ta, _numpy_tree(params))
    return ja, params, ta


def _jax_apply(ja, params, x):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(ja.apply(params, x))


@pytest.mark.parametrize("mode", ["dense", "band"])
def test_lsigf_matches_jax(mode):
    rng = np.random.default_rng(0)
    N, F, E, K, G, B = 150, 5, 2, 3, 4, 3
    S = np.stack([_banded(rng, N, 10), _banded(rng, N, 30)])
    h = rng.standard_normal((F, E, K, G)).astype(np.float32)
    b = rng.standard_normal((F, 1)).astype(np.float32)
    x = rng.standard_normal((B, G, N)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        jg = jgso.as_gso(S, mode=mode, block_size=64)
        want = np.asarray(jfilters.lsigf(jnp.asarray(h), jg, jnp.asarray(x),
                                         jnp.asarray(b)))
    tg = tgso.as_gso(S, mode=mode, block_size=64, device="cpu")
    got = tfilters.lsigf(torch.from_numpy(h), tg, torch.from_numpy(x),
                         torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_graph_filter_matches_jax():
    """Same weights, same output, including the zero-pad/slice contract
    (x with fewer nodes than the GSO)."""
    rng = np.random.default_rng(1)
    N, n_in = 60, 40
    S = _banded(rng, N, 6)
    x = rng.standard_normal((3, 2, n_in)).astype(np.float32)
    jg = jgso.as_gso(S)
    jl = jlayers.GraphFilter(2, 5, 3, 1, True)
    params = jl.init(jax.random.PRNGKey(0), jnp.asarray(x), jg)
    want = np.asarray(jl.apply(params, jnp.asarray(x), jg))
    tl = tlayers.GraphFilter(2, 5, 3, 1, True,
                             generator=torch.Generator().manual_seed(0),
                             device="cpu")
    assert tuple(tl.weight.shape) == params["params"]["weight"].shape
    assert tuple(tl.bias.shape) == params["params"]["bias"].shape
    with torch.no_grad():
        tl.weight.copy_(torch.tensor(np.asarray(params["params"]["weight"])))
        tl.bias.copy_(torch.tensor(np.asarray(params["params"]["bias"])))
    got = tl(torch.from_numpy(x), tgso.as_gso(S, device="cpu"))
    assert got.shape == (3, 5, n_in)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


def test_load_flax_params_round_trip_and_failures():
    rng = np.random.default_rng(2)
    N = 30
    S = _banded(rng, N, 5)
    args = ([1, 4, 4], [3, 3], True, "relu", [N, N], "NoPool", [1, 1],
            [6, 5], S)
    ja, params, ta = _pair(jarch.SelectionGNN, tarch.SelectionGNN, args)
    tree = _numpy_tree(params)
    # every torch parameter now holds the flax value
    np.testing.assert_array_equal(
        ta.core.readout.layers[1].weight.detach().numpy(),
        tree["params"]["MLP_0"]["TorchDense_1"]["kernel"].T)
    np.testing.assert_array_equal(ta.core.filters[0].weight.detach().numpy(),
                                  tree["params"]["GraphFilter_0"]["weight"])
    x = rng.standard_normal((4, 1, N)).astype(np.float32)
    np.testing.assert_allclose(ta(x).detach().numpy(),
                               _jax_apply(ja, params, x), **TOL)

    extra = _numpy_tree(params)
    extra["params"]["GraphFilter_2"] = {"weight": np.zeros((1,))}
    with pytest.raises(KeyError, match="GraphFilter_2"):
        load_flax_params(ta, extra)
    missing = _numpy_tree(params)
    del missing["params"]["MLP_0"]["TorchDense_1"]["bias"]
    with pytest.raises(KeyError, match="TorchDense_1"):
        load_flax_params(ta, missing)
    wrong = _numpy_tree(params)
    wrong["params"]["GraphFilter_1"]["weight"] = np.zeros((4, 1, 2, 4))
    with pytest.raises(ValueError):
        load_flax_params(ta, wrong)


@pytest.mark.parametrize("mode", ["band", "bcsr"])
def test_selection_gnn_sparse_modes_match_jax(mode):
    """N=384: three 128-blocks and a block bandwidth w >= 1."""
    rng = np.random.default_rng(3)
    N = 384
    S = _banded(rng, N, 150)
    args = ([1, 8, 8], [3, 3], True, "relu", [N, N], "NoPool", [1, 1], [5],
            S)
    ja, params, ta = _pair(jarch.SelectionGNN, tarch.SelectionGNN, args,
                           dict(gsoMode=mode), dict(gsoMode=mode))
    if mode == "band":
        assert ta.S.band_w >= 1 and ta.S.s_band.shape[1] == 3
    x = rng.standard_normal((5, 1, N)).astype(np.float32)
    y, y_gfl = ta.split_forward(x)
    np.testing.assert_allclose(y.detach().numpy(), _jax_apply(ja, params, x),
                               **TOL)
    assert y_gfl.shape == (5, 8, N)


def _quickstart_graph():
    G = jgt.Graph("SBM", 100, {"nCommunities": 5, "probIntra": 0.8,
                               "probInter": 0.2},
                  rng=np.random.default_rng(0))
    G.compute_gft()
    return G.W / np.max(np.diag(G.E).real)


def test_quickstart_model_band_matches_jax():
    """The README quick-start SelectionGNN (Degree order, MaxPoolLocal) in
    band mode, against the JAX model in its default dense mode."""
    S = _quickstart_graph()
    args = ([1, 32, 32], [5, 5], True, "relu", [10, 10], "MaxPoolLocal",
            [6, 8], [5], S)
    ja, params, ta = _pair(jarch.SelectionGNN, tarch.SelectionGNN, args,
                           dict(order="Degree"),
                           dict(order="Degree", gsoMode="band"))
    assert ta.order == ja.order
    x = np.random.default_rng(4).standard_normal((6, 1, 100)).astype(
        np.float32)
    np.testing.assert_allclose(ta(x).detach().numpy(),
                               _jax_apply(ja, params, x), **TOL)


def test_change_gso_keeps_parameters():
    rng = np.random.default_rng(5)
    N = 40
    args = ([1, 4], [3], True, "relu", [N], "NoPool", [1], [3],
            _banded(rng, N, 5))
    ja, params, ta = _pair(jarch.SelectionGNN, tarch.SelectionGNN, args)
    S2 = _banded(rng, N, 8)
    ja.changeGSO(S2)
    ta.changeGSO(S2)
    x = rng.standard_normal((3, 1, N)).astype(np.float32)
    np.testing.assert_allclose(ta(x).detach().numpy(),
                               _jax_apply(ja, params, x), **TOL)


def test_local_gnn_matches_jax():
    rng = np.random.default_rng(6)
    N = 50
    args = ([1, 6, 8], [3, 2], True, "tanh", [N, N], "NoPool", [1, 1],
            [4, 2], _banded(rng, N, 5))
    ja, params, ta = _pair(jarch.LocalGNN, tarch.LocalGNN, args,
                           dict(order="Degree"), dict(order="Degree"))
    x = rng.standard_normal((3, 1, N)).astype(np.float32)
    got = ta(x)
    assert got.shape == (3, 2, N)
    np.testing.assert_allclose(got.detach().numpy(),
                               _jax_apply(ja, params, x), **TOL)
    nodes = [0, 7, 49]
    np.testing.assert_allclose(
        ta.single_node_forward(x, nodes).detach().numpy(),
        np.asarray(ja.single_node_forward(params, x, nodes)), **TOL)


def test_inference_engine_matches_jax_on_ragged_batches():
    rng = np.random.default_rng(7)
    N = 24
    args = ([1, 8, 8], [3, 3], True, "relu", [N, N], "NoPool", [1, 1], [3],
            _banded(rng, N, 4))
    ja, params, ta = _pair(jarch.SelectionGNN, tarch.SelectionGNN, args)
    x8 = rng.standard_normal((8, 1, N)).astype(np.float32)
    jeng = jserving.InferenceEngine(ja, params, (x8,))
    teng = tserving.InferenceEngine(ta, 8, device="cpu")
    for n in (1, 3, 8):
        y = teng(x8[:n])
        assert y.shape == (n, 3) and y.dtype == torch.float32
        assert not y.requires_grad
        np.testing.assert_allclose(y.numpy(), np.asarray(jeng(x8[:n])), **TOL)
    with pytest.raises(ValueError, match="exceeds"):
        teng(rng.standard_normal((9, 1, N)).astype(np.float32))


def test_unported_options_raise():
    S = _banded(np.random.default_rng(8), 20, 3)
    with pytest.raises(NotImplementedError):
        tarch.SelectionGNN([1, 4], [2], True, "relu", [20], "NoPool", [1],
                           [2], S, coarsening=True, device="cpu")
    with pytest.raises(NotImplementedError):
        tarch.SelectionGNN([1, 4], [2], True, "relu", [20], "NoPool", [1],
                           [2], S, order="EDS", device="cpu")
