"""PyTorch port, the static-GSO recurrent family: gated_grnn, the four
hidden-state layers, GraphRecurrentNN and GatedGraphRecurrentNN in dense,
band and bcsr mode, their shard() over a CPU mesh, and a Trainer step,
held against the JAX package on the CPU with the same weights (carried
across by load_flax_params) and the same explicit z0 (the two packages'
random generators differ).

The port's band and bcsr modes run the kernels' plain versions on the CPU;
the JAX side runs dense mode, the reference. Tolerance atol = rtol = 1e-4
(f32 sums in another order, fed back through T recurrence steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from graph_neural_networks_torch import parallel as tpar
from graph_neural_networks_torch import training as ttraining
from graph_neural_networks_torch.data import Data
from graph_neural_networks_torch.models import architectures as tarch
from graph_neural_networks_torch.models import layers as tlayers
from graph_neural_networks_torch.ops import filters as tfilters
from graph_neural_networks_torch.ops import gso as tgso
from graph_neural_networks_torch.utils.params import load_flax_params
from graph_neural_networks_tpu.models import architectures as jarch
from graph_neural_networks_tpu.models import layers as jlayers
from graph_neural_networks_tpu.ops import filters as jfilters
from graph_neural_networks_tpu.ops import gso as jgso

TOL = dict(atol=1e-4, rtol=1e-4)
CPU8 = [torch.device("cpu")] * 8
GATES = [None, "time", "node", "edge"]


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, unfreeze(params))


def _graph(N=40, seed=0):
    """A sparse symmetric GSO normalized by its largest |eigenvalue|, as
    examples/epidemic.py normalizes its graph."""
    rng = np.random.default_rng(seed)
    W = rng.random((N, N)) * (rng.random((N, N)) < 0.15)
    W = (W + W.T) / 2
    np.fill_diagonal(W, 0)
    return W / np.max(np.abs(np.linalg.eigvalsh(W)))


def _band_graph(N=64, seed=0):
    """A path of clusters, banded (tests/test_parallel.py's band_graph),
    normalized as the JAX GRNN shard tests normalize it."""
    rng = np.random.default_rng(seed)
    W = np.zeros((N, N))
    for i in range(N - 1):
        W[i, i + 1] = W[i + 1, i] = 1.0
    for i in rng.integers(0, N - 4, 30):
        W[i, i + 3] = W[i + 3, i] = 0.5
    return W / np.max(np.abs(np.linalg.eigvalsh(W)))


def _grnn_args(S, K=(3, 2)):
    return (2, 3, 4, list(K), True, "tanh", "relu", "identity", [3], S)


def _pair(gate, S, mode="dense", K=(3, 2)):
    """The JAX GRNN (dense mode), its params, and the port's in `mode`."""
    kw = {} if gate is None else {"gateType": gate}
    jcls = jarch.GraphRecurrentNN if gate is None else \
        jarch.GatedGraphRecurrentNN
    tcls = tarch.GraphRecurrentNN if gate is None else \
        tarch.GatedGraphRecurrentNN
    ja = jcls(*_grnn_args(S, K), **kw)
    params = ja.init(jax.random.PRNGKey(0))
    ta = tcls(*_grnn_args(S, K), gsoMode=mode, device="cpu", **kw)
    load_flax_params(ta, _numpy_tree(params))
    return ja, params, ta


def _inputs(rng, B, T, N, H=4, F=2):
    return (rng.standard_normal((B, T, F, N)).astype(np.float32),
            rng.standard_normal((B, H, N)).astype(np.float32))


def _jax_grads(ja, params, x, z0):
    def loss(p):
        y = ja.core.apply(p, jnp.asarray(x), jnp.asarray(z0), ja.ctx)[0]
        return jnp.mean(y ** 2)
    return _numpy_tree(jax.grad(loss)(params))


def _torch_loss(ta, x, z0):
    y = ta.split_forward(x, z0=z0)[0]
    return torch.mean(y ** 2)


def _assert_grads_match(ta, jgrads):
    """Every torch parameter's gradient against the JAX leaf of the same
    flax name, brought to the flax layout."""
    leaves = jgrads["params"]
    for path, (p, transpose) in ta.flax_names().items():
        want = leaves
        for k in path:
            want = want[k]
        got = p.grad.detach().numpy()
        got = got.T if transpose is True else got
        np.testing.assert_allclose(got, want, err_msg="/".join(path), **TOL)


# ---------------------------------------------------------------------------
# gated_grnn and the hidden-state layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gate", GATES)
def test_gated_grnn_matches_jax(gate):
    """The functional in each gate mode, on given gates of the mode's
    shape: None, (B,T,1,1), (B,T,1,N), (B,T,1,N,N)."""
    rng = np.random.default_rng(1)
    N, B, T, F, H, K = 30, 2, 4, 3, 5, 3
    S = _graph(N, 1)
    a = rng.standard_normal((H, 1, K, F)).astype(np.float32) * 0.3
    bt = rng.standard_normal((H, 1, K, H)).astype(np.float32) * 0.3
    xb = rng.standard_normal((H, 1)).astype(np.float32)
    zb = rng.standard_normal((H, 1)).astype(np.float32)
    x, z0 = _inputs(rng, B, T, N, H, F)
    shape = {None: None, "time": (B, T, 1, 1), "node": (B, T, 1, N),
             "edge": (B, T, 1, N, N)}[gate]
    qh = qc = None
    if shape is not None:
        qh = rng.random(shape).astype(np.float32)
        qc = rng.random(shape).astype(np.float32)
    want = np.asarray(jfilters.gated_grnn(
        jnp.asarray(a), jnp.asarray(bt), jgso.as_gso(S), jnp.asarray(x),
        jnp.asarray(z0), jnp.tanh,
        q_hat=None if qh is None else jnp.asarray(qh),
        q_check=None if qc is None else jnp.asarray(qc),
        x_bias=jnp.asarray(xb), z_bias=jnp.asarray(zb)))
    t = torch.from_numpy
    got = tfilters.gated_grnn(
        t(a), t(bt), tgso.as_gso(S, device="cpu"), t(x), t(z0), torch.tanh,
        q_hat=None if qh is None else t(qh),
        q_check=None if qc is None else t(qc), x_bias=t(xb), z_bias=t(zb))
    assert got.shape == (B, T, H, N)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("gate", GATES)
def test_hidden_state_layers_match_jax(gate):
    """HiddenState and the time-, node- and edge-gated hidden states:
    parameter names and shapes, (z, z_T) and the gradient of every
    parameter, flax's gate heads carried across."""
    rng = np.random.default_rng(2)
    N, B, T, F, H, K = 24, 2, 3, 2, 3, 2
    S = _graph(N, 2)
    jcls = {None: jlayers.HiddenState, "time": jlayers.TimeGatedHiddenState,
            "node": jlayers.NodeGatedHiddenState,
            "edge": jlayers.EdgeGatedHiddenState}[gate]
    tcls = {None: tlayers.HiddenState, "time": tlayers.TimeGatedHiddenState,
            "node": tlayers.NodeGatedHiddenState,
            "edge": tlayers.EdgeGatedHiddenState}[gate]
    x, z0 = _inputs(rng, B, T, N, H, F)
    jg = jgso.as_gso(S)
    jl = jcls(F, H, K)
    params = jl.init(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(z0),
                     jg)
    want, want_T = jl.apply(params, jnp.asarray(x), jnp.asarray(z0), jg)
    extra = {"n_nodes": N} if gate == "time" else {}
    tl = tcls(F, H, K, generator=torch.Generator().manual_seed(0),
              device="cpu", **extra)
    tree = _numpy_tree(params)
    with torch.no_grad():
        for path, (p, transpose) in tl.flax_names(()).items():
            v = tree["params"]
            for k in path:
                v = v[k]
            assert tuple(p.shape) == (v.T.shape if transpose else v.shape)
            p.copy_(torch.tensor(v.T if transpose else v))
    flax_leaves = len(jax.tree_util.tree_leaves(params))
    assert len(tl.flax_names(())) == flax_leaves == len(list(tl.parameters()))
    tg = tgso.as_gso(S, device="cpu")
    got, got_T = tl(torch.from_numpy(x), torch.from_numpy(z0), tg)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_T.detach().numpy(), np.asarray(want_T),
                               **TOL)
    jgrad = _numpy_tree(jax.grad(lambda p: jnp.mean(jl.apply(
        p, jnp.asarray(x), jnp.asarray(z0), jg)[0] ** 2))(params))
    torch.mean(got ** 2).backward()
    for path, (p, transpose) in tl.flax_names(()).items():
        v = jgrad["params"]
        for k in path:
            v = v[k]
        g = p.grad.numpy()
        np.testing.assert_allclose(g.T if transpose else g, v,
                                   err_msg="/".join(path), **TOL)


# ---------------------------------------------------------------------------
# GraphRecurrentNN / GatedGraphRecurrentNN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["dense", "band", "bcsr"])
@pytest.mark.parametrize("gate", GATES)
def test_grnn_matches_jax(gate, mode):
    """Forward (both outputs of split_forward) and the gradient of every
    parameter against the JAX dense model, same weights and z0; band and
    bcsr at block size 128 on N = 160 (two blocks, a ragged last one)."""
    rng = np.random.default_rng(4)
    N = 160 if mode != "dense" else 40
    S = _graph(N, 4)
    ja, params, ta = _pair(gate, S, mode)
    assert ta.S.mode == mode
    x, z0 = _inputs(rng, 3, 4, N)
    want, want_out = ja.split_forward(params, x, z0=jnp.asarray(z0))
    got, got_out = ta.split_forward(x, z0=z0)
    assert got.shape == (3, 4, 3, N) and got_out.shape == (3, 4, 3, N)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_out.detach().numpy(),
                               np.asarray(want_out), **TOL)
    _torch_loss(ta, x, z0).backward()
    _assert_grads_match(ta, _jax_grads(ja, params, x, z0))


def test_grnn_z0_from_a_generator():
    """Without z0 the forward draws it from the generator it is given, or
    from one seeded 0 when none is (JAX's PRNGKey(0) default): the same
    answer on every call; single_node_forward picks (B, T, dim) at the
    original node ids."""
    S = _graph(30, 5)
    ta = tarch.GraphRecurrentNN(*_grnn_args(S), device="cpu")
    x = np.random.default_rng(5).standard_normal((2, 3, 2, 30))
    y0 = ta.apply(x)
    np.testing.assert_array_equal(y0.detach().numpy(),
                                  ta.apply(x).detach().numpy())
    z0 = torch.randn((2, 4, 30), generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(y0.detach().numpy(),
                                  ta.apply(x, z0=z0).detach().numpy())
    g = torch.Generator().manual_seed(7)
    y1, y2 = ta.apply(x, generator=g), ta.apply(x, generator=g)
    assert not torch.equal(y1, y2)       # the generator advanced
    sn = ta.single_node_forward(x, [3, 11])
    assert sn.shape == (2, 3, 3)
    np.testing.assert_array_equal(sn[1].detach().numpy(),
                                  y0[1, :, :, 11].detach().numpy())


def test_grnn_single_node_forward_and_change_gso_match_jax():
    S = _graph(30, 6)
    ja, params, ta = _pair(None, S)
    rng = np.random.default_rng(6)
    x, _ = _inputs(rng, 2, 3, 30)
    want = np.asarray(ja.single_node_forward(params, x, [4, 9]))
    got = ta.single_node_forward(x, [4, 9])
    z0 = np.array(jax.random.normal(jax.random.PRNGKey(0), (2, 4, 30)))
    # the JAX default z0 differs from the port's: compare on JAX's z0
    want_apply = np.asarray(ja.apply(params, x, z0=jnp.asarray(z0)))
    np.testing.assert_allclose(want, want_apply[np.arange(2), :, :, [4, 9]],
                               **TOL)
    assert got.shape == want.shape
    S2 = _graph(30, 7)
    ja.changeGSO(S2)
    ta.changeGSO(S2)
    np.testing.assert_allclose(
        ta.apply(x, z0=z0).detach().numpy(),
        np.asarray(ja.apply(params, x, z0=jnp.asarray(z0))), **TOL)


# ---------------------------------------------------------------------------
# shard() (JAX tests/test_parallel.py:364-418)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gate", [None, "time", "node"])
def test_grnn_shard_matches_unsharded(gate):
    """arch.shard() over a (1, 8) mesh of the CPU: the recurrence runs over
    the node-sharded ring shift, matching the unsharded port and the JAX
    dense model (forward) and the unsharded port (every gradient)."""
    S = _band_graph()
    K = (3, 3) if gate is None else (2, 2)
    ja, params, ta = _pair(gate, S, K=K)
    rng = np.random.default_rng(8)
    x = rng.random((2, 4, 2, 64)).astype(np.float32)
    z0 = np.zeros((2, 4, 64), np.float32)
    want = np.asarray(ja.apply(params, x, z0=jnp.asarray(z0)))
    _torch_loss(ta, x, z0).backward()
    g_want = [p.grad.clone() for p in ta.parameters()]
    ta.core.zero_grad(set_to_none=True)
    ta.shard(tpar.make_mesh((1, 8), devices=CPU8), 8)
    assert isinstance(ta.S, tpar.ShardedGso) and ta.S.uses_ring
    got = ta.apply(x, z0=z0)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    _torch_loss(ta, x, z0).backward()
    for g, w in zip((p.grad for p in ta.parameters()), g_want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)


def test_grnn_shard_rcm_refuses_without_a_gather_map():
    """order='rcm' needs an input gather map, which a GRNN has not (JAX's
    message); the model is left as it was."""
    ta = tarch.GraphRecurrentNN(*_grnn_args(_band_graph()), device="cpu")
    S_before = ta.S
    with pytest.raises(ValueError, match="needs an input gather map"):
        ta.shard(tpar.make_mesh((1, 8), devices=CPU8), 8, order="rcm")
    assert ta.S is S_before


# ---------------------------------------------------------------------------
# Training: the Trainer's generator
# ---------------------------------------------------------------------------

class _Sequences(Data):
    """Seeded (n, T, 1, N) states and (n, T, N) infected indicators, the
    shapes of the epidemic task."""

    def __init__(self, rng, n, T, N):
        super().__init__()
        self.nTrain = self.nValid = self.nTest = n
        for split in ("train", "valid", "test"):
            self.samples[split]["signals"] = rng.integers(
                0, 3, (n, T, 1, N)).astype(np.float32)
            self.samples[split]["targets"] = rng.integers(
                0, 2, (n, T, N)).astype(np.float32)

    def evaluate(self, yHat, y):
        return float(ttraining.losses.f1_score_loss(
            torch.as_tensor(yHat), torch.as_tensor(y)))


def test_trainer_passes_an_advancing_generator(tmp_path, monkeypatch):
    """The Trainer hands a GRNN's split_forward its own generator, seeded
    from `seed`, which advances each step: the z0 of two steps differ and
    the first equals a fresh generator's first draw; validation draws from
    one seeded 0. The step is an f1-loss Adam step."""
    S = _graph(20, 9)
    arch = tarch.GraphRecurrentNN(1, 2, 4, [3, 3], True, "tanh", "relu",
                                  "relu", [2], S, device="cpu")
    data = _Sequences(np.random.default_rng(9), 4, 3, 20)
    seen = []
    orig = arch.split_forward

    def spy(x, generator=None, z0=None):
        # the next draw of the generator the forward was given
        seen.append(None if generator is None else
                    torch.randn((1,), generator=_copy_gen(generator)))
        return orig(x, generator=generator, z0=z0)
    monkeypatch.setattr(arch, "split_forward", spy)
    model = ttraining.Model(arch, ttraining.losses.f1_score_loss,
                            {"name": "ADAM", "lr": 5e-4}, ttraining.Trainer,
                            ttraining.evaluate, name="grnn",
                            saveDir=str(tmp_path))
    trainer = ttraining.Trainer(model, data, 1, 2, seed=3)
    assert trainer.generator is not None
    state0 = trainer.generator.get_state()
    trainer.train_batch(np.arange(2))
    assert not torch.equal(trainer.generator.get_state(), state0)
    trainer.train_batch(np.arange(2, 4))
    trainer._valid_cost()
    assert seen[2] is None                  # validation: the default seed 0
    first = torch.randn((1,), generator=torch.Generator().manual_seed(3))
    assert not torch.equal(seen[0], seen[1])
    # the first step's generator was seeded 3: its next draw equals the
    # first draw of a fresh generator seeded 3
    assert torch.equal(seen[0], first)
    out = model.train(data, nEpochs=1, batchSize=2, validationInterval=1)
    assert np.isfinite(out["lossTrain"]).all()


def _copy_gen(gen):
    g = torch.Generator(device=gen.device)
    g.set_state(gen.get_state())
    return g


def test_trainer_leaves_deterministic_forwards_alone():
    """A forward without a generator argument gets none."""
    S = _graph(20, 10)
    arch = tarch.SelectionGNN([1, 3], [2], True, "relu", [20], "NoPool", [1],
                              [2], S, device="cpu")
    data = _Sequences(np.random.default_rng(10), 2, 1, 20)
    model = ttraining.Model(arch, ttraining.losses.cross_entropy_loss,
                            {"name": "ADAM", "lr": 1e-3}, ttraining.Trainer,
                            ttraining.evaluate)
    assert ttraining.Trainer(model, data, 1, 2).generator is None


# ---------------------------------------------------------------------------
# Refusals naming ROADMAP item 8 (the edge-list GSO)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cls,kw", [
    (tarch.GraphRecurrentNN, {}),
    (tarch.GatedGraphRecurrentNN, {"gateType": "node"}),
])
def test_edge_gso_mode_raises_naming_item_8(cls, kw):
    with pytest.raises(NotImplementedError, match="item 8"):
        cls(*_grnn_args(_graph(20, 11)), gsoMode="edge", device="cpu", **kw)


def test_edge_gated_edge_list_raises_naming_item_8():
    rng = np.random.default_rng(12)
    N, H, F = 20, 3, 2
    a = torch.zeros((H, 1, 2, F))
    bt = torch.zeros((H, 1, 2, H))
    x = torch.from_numpy(rng.standard_normal((1, 2, F, N)).astype(np.float32))
    with pytest.raises(NotImplementedError, match="item 8"):
        tfilters.gated_grnn(a, bt, tgso.as_gso(_graph(N, 12), device="cpu"),
                            x, torch.zeros((1, H, N)), torch.tanh,
                            edge_gated=True)


def test_unknown_gate_type_raises():
    with pytest.raises(ValueError, match="gateType"):
        tarch.GatedGraphRecurrentNN(*_grnn_args(_graph(20, 13)),
                                    gateType="spectral", device="cpu")
