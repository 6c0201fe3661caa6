"""PyTorch port, the static filter families: the graph helpers they need
(compute_nonzero_rows, nv_copy_nodes, ev_sparsity_pattern, spline_basis),
the functionals (spectral_gf, nvgf, evgf, evgf_edges, jarma), the
architectures SpectralGNN, NodeVariantGNN, EdgeVariantGNN, LocalEdgeNet,
ARMAfilterGNN, LocalARMA, AggregationGNN and MultiNodeAggregationGNN, and
load_flax_params on a flax Conv kernel and on MultiNodeAggregationGNN's
parameter tree, held against the JAX package on the CPU with the same
weights (carried across by load_flax_params).

Tolerances: the helpers exactly (integer maps and masks) or at 1e-12
(f64 spline values); the functionals and the architectures (forward and
every parameter's gradient) at atol = rtol = 1e-4 (f32 sums in another
order; the readouts contract F*N features).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from graph_neural_networks_torch.models import architectures as tarch
from graph_neural_networks_torch.ops import filters as tfilters
from graph_neural_networks_torch.ops import gso as tgso
from graph_neural_networks_torch.utils import graph as tgt
from graph_neural_networks_torch.utils.params import load_flax_params
from graph_neural_networks_tpu.models import architectures as jarch
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


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, unfreeze(params))


def _graph(N=16, seed=0, density=0.25, E=1):
    """E sparse symmetric GSOs, connected (a path plus random edges),
    normalized by the largest |eigenvalue|."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(E):
        W = rng.random((N, N)) * (rng.random((N, N)) < density)
        W[np.arange(N - 1), np.arange(1, N)] += 0.5
        W = (W + W.T) / 2
        np.fill_diagonal(W, 0)
        out.append(W / np.max(np.abs(np.linalg.eigvalsh(W))))
    return out[0] if E == 1 else np.stack(out)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


# ---------------------------------------------------------------------------
# The graph helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_rows", [None, 5])
def test_compute_nonzero_rows_matches_jax(n_rows):
    S = _graph(20, 1)
    got = tgt.compute_nonzero_rows(S, n_rows)
    want = jgt.compute_nonzero_rows(S, n_rows)
    assert len(got) == len(want) == (n_rows or 20)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("M", [1, 3, 7, 20])
def test_nv_copy_nodes_matches_jax(M):
    S = _graph(20, 2, density=0.1)
    got = tgt.nv_copy_nodes(S, M)
    np.testing.assert_array_equal(got, jgt.nv_copy_nodes(S, M))
    assert got.max() < max(M, 1) or M >= 20


@pytest.mark.parametrize("M", [None, 6])
@pytest.mark.parametrize("E", [1, 2])
def test_ev_sparsity_pattern_matches_jax(M, E):
    S = _graph(12, 3, E=E)
    for g, w in zip(tgt.ev_sparsity_pattern(S, M),
                    jgt.ev_sparsity_pattern(S, M)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("K,x", [(4, 9), (6, None), (5, 1)])
def test_spline_basis_matches_jax(K, x):
    """At evenly spaced points (x scalar) and at a graph's eigenvalues."""
    if x is None:
        x = np.linalg.eigvalsh(_graph(15, 4))
    got = tgt.spline_basis(K, x)
    np.testing.assert_allclose(got, jgt.spline_basis(K, x), atol=1e-12,
                               rtol=1e-12)


# ---------------------------------------------------------------------------
# The functionals
# ---------------------------------------------------------------------------

def test_spectral_gf_matches_jax():
    rng = np.random.default_rng(5)
    E, N, F, G, B = 2, 14, 3, 2, 3
    S = _graph(N, 5, E=E)
    w, V = np.linalg.eigh(S)
    VH = np.transpose(V, (0, 2, 1))
    h = rng.standard_normal((F, E, G, N))
    x = rng.standard_normal((B, G, N))
    b = rng.standard_normal((F, 1))
    want = jfilters.spectral_gf(_j(h), _j(V), _j(VH), _j(x), _j(b))
    got = tfilters.spectral_gf(_t(h), _t(V), _t(VH), _t(x), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mode", ["dense", "band", "bcsr"])
def test_nvgf_matches_jax(mode):
    """On band and bcsr the register runs the kernels' plain versions."""
    rng = np.random.default_rng(6)
    E, N, F, G, K, B = 1, 150, 3, 2, 3, 2
    S = _graph(N, 6, density=0.02)
    h = rng.standard_normal((F, E, K, G, N))
    x = rng.standard_normal((B, G, N))
    want = jfilters.nvgf(_j(h), jgso.as_gso(S), _j(x))
    got = tfilters.nvgf(_t(h), tgso.as_gso(S, mode=mode, device="cpu"),
                        _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("K", [1, 3])
def test_evgf_matches_jax(K):
    rng = np.random.default_rng(7)
    E, N, F, G, B = 2, 10, 2, 3, 2
    Phi = rng.standard_normal((F, E, K, G, N, N)) * 0.3
    x = rng.standard_normal((B, G, N))
    b = rng.standard_normal((F, 1))
    want = jfilters.evgf(_j(Phi), _j(x), _j(b))
    got = tfilters.evgf(_t(Phi), _t(x), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("K", [1, 2, 4])
def test_evgf_edges_matches_jax(K):
    """index_add_ over the edges' rows in place of segment_sum; also equal
    to evgf on the same weights scattered into dense matrices."""
    rng = np.random.default_rng(8)
    E, N, F, G, B = 1, 12, 2, 3, 2
    S = _graph(N, 8)
    row, col = np.nonzero(np.abs(S[None]).sum(0) > 0)
    w0 = rng.standard_normal((F, E, G, N))
    wk = (rng.standard_normal((F, E, K - 1, G, len(row))) * 0.5
          if K > 1 else None)
    x = rng.standard_normal((B, G, N))
    want = jfilters.evgf_edges(_j(w0), None if wk is None else _j(wk),
                               jnp.asarray(row), jnp.asarray(col), _j(x))
    got = tfilters.evgf_edges(_t(w0), None if wk is None else _t(wk),
                              torch.from_numpy(row), torch.from_numpy(col),
                              _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    Phi = np.zeros((F, E, K, G, N, N))
    Phi[:, :, 0, :, np.arange(N), np.arange(N)] = np.moveaxis(w0, -1, 0)
    for k in range(1, K):
        Phi[:, :, k, :, row, col] = np.moveaxis(wk[:, :, k - 1], -1, 0)
    np.testing.assert_allclose(got.numpy(),
                               tfilters.evgf(_t(Phi), _t(x)).numpy(), **TOL)


@pytest.mark.parametrize("t_max", [0, 1, 5])
def test_jarma_matches_jax(t_max):
    rng = np.random.default_rng(9)
    E, N, F, G, P, K, B = 2, 12, 3, 2, 2, 3, 2
    S = _graph(N, 9, E=E)
    S = S + 0.1 * np.eye(N)[None]        # a diagonal for Sbar to hold
    psi = rng.uniform(3, 5, (F, E, P, G))
    varphi = rng.standard_normal((F, E, P, G))
    phi = rng.standard_normal((F, E, K, G))
    x = rng.standard_normal((B, G, N))
    b = rng.standard_normal((F, 1))
    want = jfilters.jarma(_j(psi), _j(varphi), _j(phi), jgso.as_gso(S),
                          _j(x), _j(b), t_max=t_max)
    got = tfilters.jarma(_t(psi), _t(varphi), _t(phi),
                         tgso.as_gso(S, device="cpu"), _t(x), _t(b),
                         t_max=t_max)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# The architectures
# ---------------------------------------------------------------------------

N_ARCH = 16


def _s_arch(E=1):
    return _graph(N_ARCH, 10, E=E)


# (name, JAX class, port class, positional args without GSO/order, kwargs)
CASES = {
    "spectral_M=N": (jarch.SpectralGNN, tarch.SpectralGNN,
                     lambda S: ([1, 3, 2], [N_ARCH, N_ARCH], True, "relu",
                                [N_ARCH, N_ARCH], "NoPool", [1, 1], [4], S),
                     {}),
    "spectral_M<N_pooled": (jarch.SpectralGNN, tarch.SpectralGNN,
                            lambda S: ([1, 3, 2], [6, 5], True, "relu",
                                       [10, 6], "MaxPoolLocal", [2, 2], [4],
                                       S), {}),
    "node_variant": (jarch.NodeVariantGNN, tarch.NodeVariantGNN,
                     lambda S: ([2, 3, 2], [3, 2], [4, 16], True, "tanh",
                                [N_ARCH, N_ARCH], "NoPool", [1, 1], [3], S),
                     {}),
    "edge_variant_dense": (jarch.EdgeVariantGNN, tarch.EdgeVariantGNN,
                           lambda S: ([1, 3, 2], [3, 2], [N_ARCH, 5], True,
                                      "relu", [N_ARCH, N_ARCH], "NoPool",
                                      [1, 1], [3], S), {}),
    "edge_variant_edge": (jarch.EdgeVariantGNN, tarch.EdgeVariantGNN,
                          lambda S: ([1, 3, 2], [3, 1], [N_ARCH, 5], True,
                                     "relu", [N_ARCH, N_ARCH], "NoPool",
                                     [1, 1], [3], S), {"evMode": "edge"}),
    "edge_variant_edge_E2": (jarch.EdgeVariantGNN, tarch.EdgeVariantGNN,
                             lambda S: ([1, 2], [3], [6], True, "relu",
                                        [N_ARCH], "NoPool", [1], [3], S),
                             {"evMode": "edge", "E": 2}),
    "local_edge_net_dense": (jarch.LocalEdgeNet, tarch.LocalEdgeNet,
                             lambda S: ([1, 3], [2], [N_ARCH], True, "relu",
                                        [N_ARCH], "NoPool", [1], [2], S),
                             {}),
    "local_edge_net_edge": (jarch.LocalEdgeNet, tarch.LocalEdgeNet,
                            lambda S: ([1, 3], [3], [7], True, "relu",
                                       [N_ARCH], "NoPool", [1], [2], S),
                            {"evMode": "edge"}),
    "arma": (jarch.ARMAfilterGNN, tarch.ARMAfilterGNN,
             lambda S: ([1, 3, 2], [2, 1], [3, 2], True, "relu",
                        [N_ARCH, N_ARCH], "NoPool", [1, 1], [4], S), {}),
    "local_arma": (jarch.LocalARMA, tarch.LocalARMA,
                   lambda S: ([2, 3], [2], [2], True, "tanh", [N_ARCH],
                              "NoPool", [1], [2], S), {"tMax": 3}),
    "aggregation": (jarch.AggregationGNN, tarch.AggregationGNN,
                    lambda S: ([1, 3, 4], [3, 2], True, "relu", "NoPool",
                               [2, 1], [5, 3], S), {"maxN": 10}),
    "aggregation_multinode": (jarch.AggregationGNN, tarch.AggregationGNN,
                              lambda S: ([2, 3], [3], True, "tanh", "NoPool",
                                         [1], [4], S),
                              {"maxN": 8, "nNodes": 3,
                               "dimLayersAggMLP": [5]}),
    "aggregation_E2": (jarch.AggregationGNN, tarch.AggregationGNN,
                       lambda S: ([1, 2], [2], True, "relu", "NoPool", [2],
                                  [3], S), {"maxN": 6, "E": 2}),
    "multinode_aggregation": (
        jarch.MultiNodeAggregationGNN, tarch.MultiNodeAggregationGNN,
        lambda S: ([3, 2], [6, 5], [[1, 2], [3, 3], [2]], [[2], [2]], True,
                   "relu", "NoPool", [[1], [1]], [4], S), {}),
}


def _build(name, order=None):
    jcls, tcls, args, kw = CASES[name]
    kw = dict(kw)
    S = _s_arch(kw.pop("E", 1))
    a = args(S)
    if order is not None:
        kw["order"] = order
    ja = jcls(*a, **kw)
    params = ja.init(jax.random.PRNGKey(1))
    ta = tcls(*a, device="cpu", **kw)
    load_flax_params(ta, _numpy_tree(params))
    return ja, params, ta


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _flax_layout(g, transpose):
    if isinstance(transpose, tuple):
        return np.transpose(g, np.argsort(transpose))
    return g.T if transpose else g


@pytest.mark.parametrize("name", sorted(CASES))
def test_architecture_matches_jax(name):
    """Forward and the gradient of every parameter, with the JAX weights
    carried across."""
    ja, params, ta = _build(name)
    F0 = CASES[name][2](None)[2][0][0] if name == "multinode_aggregation" \
        else CASES[name][2](None)[0][0]
    x = np.random.default_rng(11).standard_normal(
        (3, F0, N_ARCH)).astype(np.float32)
    want = np.asarray(ja.apply(params, x))
    got = ta.apply(x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)

    jgrad = _numpy_tree(jax.grad(
        lambda p: jnp.mean(ja.apply(p, jnp.asarray(x)) ** 2))(params))
    torch.mean(ta.apply(x) ** 2).backward()
    tree = jgrad.get("params", jgrad)
    names = ta.flax_names()
    assert len(names) == len(jax.tree_util.tree_leaves(params))
    for path, (p, transpose) in names.items():
        np.testing.assert_allclose(
            _flax_layout(p.grad.numpy(), transpose), _leaf(tree, path),
            err_msg="/".join(map(str, path)), **TOL)


@pytest.mark.parametrize("name", ["spectral_M<N_pooled", "edge_variant_dense",
                                  "arma"])
def test_architecture_change_gso_and_order_match_jax(name):
    """Degree ordering, then changeGSO to another graph: the structure
    tables (eigenbasis and splines, masks) are rebuilt, the weights
    kept."""
    ja, params, ta = _build(name, order="Degree")
    assert list(ta.order) == [int(i) for i in ja.order]
    S2 = _graph(N_ARCH, 12)
    ja.changeGSO(S2)
    ta.changeGSO(S2)
    x = np.random.default_rng(12).standard_normal(
        (2, 1, N_ARCH)).astype(np.float32)
    np.testing.assert_allclose(ta.apply(x).detach().numpy(),
                               np.asarray(ja.apply(params, x)), **TOL)


def test_local_edge_net_single_node_forward_matches_jax():
    ja, params, ta = _build("local_edge_net_dense", order="Degree")
    x = np.random.default_rng(13).standard_normal(
        (2, 1, N_ARCH)).astype(np.float32)
    want = np.asarray(ja.single_node_forward(params, x, [3, 7]))
    got = ta.single_node_forward(x, [3, 7])
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


def test_edge_variant_parameter_shapes():
    """Dense: weightEV (F,E,K,G,N,N), and weightLSI when M < N; edge:
    weightEV0 (F,E,G,N) and weightEVk (F,E,K-1,G,nnz) on the support."""
    _, _, dense = _build("edge_variant_dense")
    l0, l1 = dense.core.filters
    assert l0.weightEV.shape == (3, 1, 3, 1, N_ARCH, N_ARCH)
    assert l0.weightLSI is None and l1.weightLSI.shape == (2, 1, 2, 3)
    _, _, edge = _build("edge_variant_edge")
    l0, l1 = edge.core.filters
    nnz = edge.ctx["ev_pattern"][0][0].shape[0]
    assert l0.weightEV0.shape == (3, 1, 1, N_ARCH)
    assert l0.weightEVk.shape == (3, 1, 2, 1, nnz)
    assert l1.weightEVk is None                   # K = 1


def test_arma_inverse_weight_init_range():
    """inverseWeight ~ U(1 + 1/stdv, 1 + 2/stdv), stdv = 1/sqrt(G*P)."""
    ta = tarch.ARMAfilterGNN([2, 3], [3], [4], True, "relu", [N_ARCH],
                             "NoPool", [1], [2], _s_arch(), device="cpu")
    w = ta.core.filters[0].inverseWeight
    lo, hi = 1 + np.sqrt(2 * 3), 1 + 2 * np.sqrt(2 * 3)
    assert w.shape == (3, 1, 3, 2)
    assert float(w.detach().min()) >= lo and float(w.detach().max()) <= hi


def test_unknown_ev_mode_raises():
    with pytest.raises(ValueError, match="evMode"):
        tarch.EdgeVariantGNN([1, 2], [2], [4], True, "relu", [N_ARCH],
                             "NoPool", [1], [2], _s_arch(), evMode="sparse",
                             device="cpu")


# ---------------------------------------------------------------------------
# load_flax_params on a Conv kernel and on MultiNodeAggregationGNN's tree
# ---------------------------------------------------------------------------

def test_load_flax_params_permutes_a_conv_kernel():
    """A flax Conv kernel (k, in, out) lands in torch's (out, in, k)."""
    _, params, ta = _build("aggregation")
    tree = _numpy_tree(params)["params"]
    for l, conv in enumerate(ta.core.convs):
        k = tree[f"Conv_{l}"]["kernel"]
        assert k.ndim == 3
        np.testing.assert_array_equal(conv.weight.detach().numpy(),
                                      np.transpose(k, (2, 1, 0)))
        np.testing.assert_array_equal(conv.bias.detach().numpy(),
                                      tree[f"Conv_{l}"]["bias"])


def test_load_flax_params_takes_the_multinode_tree():
    """{'inner': [[...]], 'mlp': ...}: every leaf lands; a missing or a
    wrongly shaped one is refused."""
    _, params, ta = _build("multinode_aggregation")
    tree = _numpy_tree(params)
    assert set(tree) == {"inner", "mlp"}
    np.testing.assert_array_equal(
        ta.inner[0][2].core.convs[0].weight.detach().numpy(),
        np.transpose(tree["inner"][0][2]["params"]["Conv_0"]["kernel"],
                     (2, 1, 0)))
    np.testing.assert_array_equal(
        ta._mlp.layers[0].weight.detach().numpy(),
        tree["mlp"]["params"]["TorchDense_0"]["kernel"].T)
    del tree["inner"][0][1]["params"]["Conv_0"]["bias"]
    with pytest.raises(KeyError, match="torch-only"):
        load_flax_params(ta, tree)
    tree = _numpy_tree(params)
    tree["mlp"]["params"]["TorchDense_0"]["kernel"] = np.zeros((3, 4))
    with pytest.raises(ValueError, match="TorchDense_0"):
        load_flax_params(ta, tree)
