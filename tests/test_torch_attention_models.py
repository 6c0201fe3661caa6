"""PyTorch port, attention models: the three attention layers, the three
attention architectures (dense and band mode) and the InferenceEngine over
a band GAT, held against the JAX package on the CPU with the same weights
(carried across by load_flax_params). The port's band mode runs the flash
path with the kernels' plain versions; the JAX band mode runs its XLA band
path (the CPU backend). Every S is non-symmetric.

Tolerance atol = rtol = 1e-4: two attention layers of f32 softmax and
aggregation sums in another order, then the MLP readout over F*N features.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from graph_neural_networks_torch import serving as tserving
from graph_neural_networks_torch.models import architectures as tarch
from graph_neural_networks_torch.models import layers as tlayers
from graph_neural_networks_torch.ops import gso as tgso
from graph_neural_networks_torch.utils.params import load_flax_params
from graph_neural_networks_tpu import serving as jserving
from graph_neural_networks_tpu.models import architectures as jarch
from graph_neural_networks_tpu.models import layers as jlayers
from graph_neural_networks_tpu.ops import gso as jgso


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine: one intra-op thread
    keeps the many small torch ops here from oversubscribing its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(atol=1e-4, rtol=1e-4)


def _graph(N, half, seed, per_row=3):
    """Non-symmetric banded S with nonzeros within `half` of the diagonal,
    scaled to a unit spectral-radius bound."""
    rng = np.random.default_rng(seed)
    S = np.zeros((N, N), np.float32)
    for i in range(N):
        js = np.clip(i + rng.integers(-half, half + 1, per_row), 0, N - 1)
        S[i, js] = rng.random(len(js))
    np.fill_diagonal(S, 0)
    assert not np.allclose(S, S.T)
    return S / np.abs(S).sum(1).max()


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, unfreeze(params))


def _pair(cls_j, cls_t, args, mode, seed=0, **kwargs):
    """The JAX architecture, its params, and the torch one with them."""
    ja = cls_j(*args, attentionMode=mode, **kwargs)
    params = ja.init(jax.random.PRNGKey(seed))
    ta = cls_t(*args, attentionMode=mode, device="cpu", **kwargs)
    load_flax_params(ta, _numpy_tree(params))
    return ja, params, ta


LAYERS = {
    "gat": (lambda G, F, concat: jlayers.GraphAttentional(
                G, F, 2, 2, jax.nn.relu, concat),
            lambda G, F, concat, gen: tlayers.GraphAttentional(
                G, F, 2, 2, torch.relu, concat, generator=gen,
                device="cpu")),
    "gcat": (lambda G, F, concat: jlayers.GraphFilterAttentional(
                 G, F, 3, 2, 2, True, jax.nn.relu, concat),
             lambda G, F, concat, gen: tlayers.GraphFilterAttentional(
                 G, F, 3, 2, 2, True, torch.relu, concat, generator=gen,
                 device="cpu")),
    "ev": (lambda G, F, concat: jlayers.EdgeVariantAttentional(
               G, F, 3, 2, 2, True, jax.nn.tanh, concat),
           lambda G, F, concat, gen: tlayers.EdgeVariantAttentional(
               G, F, 3, 2, 2, True, torch.tanh, concat, generator=gen,
               device="cpu")),
}


@pytest.mark.parametrize("concat", [True, False])
@pytest.mark.parametrize("mode", ["dense", "band"])
@pytest.mark.parametrize("kind", sorted(LAYERS))
def test_attention_layers_match_jax(kind, mode, concat):
    """Same weights, same output, E = 2 edge features, including the
    zero-pad/slice contract (x with fewer nodes than the GSO)."""
    rng = np.random.default_rng(1)
    N, n_in, G, F = 150, 130, 3, 4
    S = np.stack([_graph(N, 40, 2), _graph(N, 70, 3)])
    x = rng.standard_normal((2, G, n_in)).astype(np.float32)
    make_j, make_t = LAYERS[kind]
    jg = jgso.as_gso(S, mode=mode, block_size=64)
    jl = make_j(G, F, concat)
    params = jl.init(jax.random.PRNGKey(0), jnp.asarray(x), jg)
    want = np.asarray(jl.apply(params, jnp.asarray(x), jg))
    tl = make_t(G, F, concat, torch.Generator().manual_seed(0))
    tree = _numpy_tree(params)["params"]
    assert sorted(tree) == sorted(n for n, _ in tl.named_parameters())
    with torch.no_grad():
        for name, p in tl.named_parameters():
            assert tuple(p.shape) == tree[name].shape, name
            p.copy_(torch.tensor(tree[name]))
    got = tl(torch.from_numpy(x),
             tgso.as_gso(S, mode=mode, block_size=64, device="cpu"))
    assert got.shape == ((2, 2 * F, n_in) if concat else (2, F, n_in))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


def test_heads_concatenate_feature_order():
    y = np.random.default_rng(2).standard_normal((2, 3, 4, 5)).astype(
        np.float32)
    got = tlayers._heads_out(torch.from_numpy(y), torch.relu, True)
    want = jlayers._heads_out(jnp.asarray(y), jax.nn.relu, True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # feature p*F + f of the concatenation is head p's feature f
    np.testing.assert_array_equal(got[:, 1 * 4 + 2].numpy(),
                                  np.maximum(y[:, 1, 2], 0))


N_ARCH = 200   # two 128-blocks, ragged (Np = 256), block bandwidth w = 1
ARCHS = {
    "gat": (jarch.GraphAttentionNetwork, tarch.GraphAttentionNetwork,
            ([2, 4, 4], [2, 2], "relu", [N_ARCH, N_ARCH], "NoPool", [1, 1],
             [3], True), {}),
    "gcat": (jarch.GraphConvolutionAttentionNetwork,
             tarch.GraphConvolutionAttentionNetwork,
             ([2, 4, 4], [3, 2], [2, 2], True, "relu", [N_ARCH, N_ARCH],
              "NoPool", [1, 1], [3]), {}),
    "ev": (jarch.EdgeVariantAttention, tarch.EdgeVariantAttention,
           ([2, 4, 4], [2, 2], [2, 1], True, "tanh", [N_ARCH, N_ARCH],
            "NoPool", [1, 1], [3]), {}),
    "gat-pooled": (jarch.GraphAttentionNetwork, tarch.GraphAttentionNetwork,
                   ([2, 4, 4], [2, 2], "relu", [80, 40], "MaxPoolLocal",
                    [3, 3], [3], True), dict(order="Degree")),
}


@pytest.mark.parametrize("mode", ["dense", "band"])
@pytest.mark.parametrize("kind", sorted(ARCHS))
def test_attention_architectures_match_jax(kind, mode):
    cls_j, cls_t, args, kwargs = ARCHS[kind]
    S = _graph(N_ARCH, 120, 4)
    ja, params, ta = _pair(cls_j, cls_t, args + (S,), mode, **kwargs)
    assert ta.S.mode == mode and ta.order == ja.order
    if mode == "band":
        assert ta.S.band_w >= 1 and ta.S.s_band.shape[1] == 2
    x = np.random.default_rng(5).standard_normal((3, 2, N_ARCH)).astype(
        np.float32)
    y, y_gfl = ta.split_forward(x)
    want, want_gfl = ja.split_forward(params, x)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(y_gfl.detach().numpy(), np.asarray(want_gfl),
                               **TOL)


def test_band_gat_change_gso_keeps_parameters():
    cls_j, cls_t, args, _ = ARCHS["gat"]
    ja, params, ta = _pair(cls_j, cls_t, args + (_graph(N_ARCH, 100, 6),),
                           "band")
    S2 = _graph(N_ARCH, 60, 7)
    ja.changeGSO(S2)
    ta.changeGSO(S2)
    x = np.random.default_rng(8).standard_normal((2, 2, N_ARCH)).astype(
        np.float32)
    np.testing.assert_allclose(ta(x).detach().numpy(),
                               np.asarray(ja.apply(params, x)), **TOL)


def test_load_flax_params_attention_names():
    cls_j, cls_t, args, _ = ARCHS["gcat"]
    ja, params, ta = _pair(cls_j, cls_t, args + (_graph(N_ARCH, 50, 9),),
                           "dense")
    tree = _numpy_tree(params)["params"]
    assert sorted(tree) == ["GraphFilterAttentional_0",
                            "GraphFilterAttentional_1", "MLP_0"]
    np.testing.assert_array_equal(
        ta.core.filters[1].filterWeight.detach().numpy(),
        tree["GraphFilterAttentional_1"]["filterWeight"])
    extra = _numpy_tree(params)
    extra["params"]["GraphAttentional_0"] = {"mixer": np.zeros((1,))}
    with pytest.raises(KeyError, match="GraphAttentional_0"):
        load_flax_params(ta, extra)


def test_inference_engine_band_gat_matches_jax():
    cls_j, cls_t, args, _ = ARCHS["gat"]
    ja, params, ta = _pair(cls_j, cls_t, args + (_graph(N_ARCH, 120, 10),),
                           "band")
    rng = np.random.default_rng(11)
    x8 = rng.standard_normal((8, 2, N_ARCH)).astype(np.float32)
    jeng = jserving.InferenceEngine(ja, params, (x8,))
    teng = tserving.InferenceEngine(ta, 8, device="cpu")
    for n in (8, 5, 1):
        y = teng(x8[:n])
        assert y.shape == (n, 3) and y.dtype == torch.float32
        assert not y.requires_grad
        np.testing.assert_allclose(y.numpy(), np.asarray(jeng(x8[:n])),
                                   **TOL)


def test_band_gat_trains_after_serving():
    """The band structure first built by a served request (inside
    inference mode) is kept on the GSO shared with the caller's arch; a
    later forward with grad enabled saves it for backward."""
    _, cls_t, args, _ = ARCHS["gat"]
    ta = cls_t(*args, _graph(N_ARCH, 120, 13), attentionMode="band",
               device="cpu", generator=torch.Generator().manual_seed(0))
    x = np.random.default_rng(14).standard_normal((4, 2, N_ARCH)).astype(
        np.float32)
    served = tserving.InferenceEngine(ta, 4, device="cpu")(x)
    assert ta.S._band_auxes is not None
    assert not any(t.is_inference() for aux in ta.S._band_auxes
                   for t in aux)
    y = ta(x)
    y.square().sum().backward()
    assert all(p.grad is not None for p in ta.parameters())
    np.testing.assert_allclose(y.detach().numpy(), served.numpy(), **TOL)


def test_unported_attention_modes_raise():
    S = _graph(40, 5, 12)
    args = ([1, 2], [2], "relu", [40], "NoPool", [1], [2], True, S)
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        tarch.GraphAttentionNetwork(*args, attentionMode="edge",
                                    device="cpu")
    with pytest.raises(ValueError, match="attentionMode"):
        tarch.GraphAttentionNetwork(*args, attentionMode="bcsr",
                                    device="cpu")
