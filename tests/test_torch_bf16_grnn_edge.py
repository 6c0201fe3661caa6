"""PyTorch port, bf16 of the models whose forward computes in f32 and of
the edge-list GSO (ROADMAP item 2.2), held against the JAX package's bf16
engine and bf16 Trainer on the CPU with the same weights (carried across
by load_flax_params):

  * ``InferenceEngine(..., dtype=torch.bfloat16)`` of GraphRecurrentNN and
    GatedGraphRecurrentNN (time, node and edge gates) in dense, band, bcsr
    and edge mode, and sharded over a 4-shard ``parallel.Mesh`` of the CPU,
    against JAX's bf16 engine answering ``(x, z0)`` on the z0 the port's
    engine draws (the JAX side in dense or edge mode: its band and bcsr
    kernels would run in interpret mode; the port's band, bcsr and sharded
    shifts run their kernels' plain versions in bf16);
    MultiNodeAggregationGNN; GAT, GCAT and EdgeVariantAttention in edge
    mode; their introspection and export;
  * ``Trainer(precision="bf16")`` on an EdgeList context (GAT in edge mode,
    bf16 on the bf16 s_val; the GRNN in edge mode, ``compute_f32``, z0
    fixed by the batch size on both sides): the first step's gradients and
    three steps' losses;
  * the EdgeList as a pytree: padding and casting keep its integer tables
    and n_nodes.

Tolerances: an engine within 1e-2 of the largest |y| (bf16 rounds the
activations and products of every layer, at other points in the two
frameworks; the port's edge-list segment sums accumulate in f32 and round
once, JAX's sum in bf16); a trainer's first-step gradients within 2e-2 of
each leaf's largest |g| (the GAT's: see its test) and its losses within
rtol 0.05, atol 0.02 (tests/test_torch_bf16_training.py's bounds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree

from graph_neural_networks_torch import kernels
from graph_neural_networks_torch import parallel as tpar
from graph_neural_networks_torch import serving as tserving
from graph_neural_networks_torch import training as ttrain
from graph_neural_networks_torch.models import architectures as tarch
from graph_neural_networks_torch.ops import attention_sparse as tasp
from graph_neural_networks_torch.ops import gso as tgso
from graph_neural_networks_torch.parallel import shift as tshift
from graph_neural_networks_torch.utils.params import load_flax_params
from graph_neural_networks_tpu import serving as jserving
from graph_neural_networks_tpu import training as jtrain
from graph_neural_networks_tpu.data.base import Data as JData
from graph_neural_networks_tpu.models import architectures as jarch
from tests.test_torch_bf16_training import (_assert_grads,
                                            _leaves_by_name, _numpy_tree,
                                            _sbm)
from tests.test_torch_edge_attention import ARCHS, N_ARCH, _init
from tests.test_torch_edge_attention import _graph as _edge_graph
from tests.test_torch_grnn import _band_graph, _pair


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine: one intra-op thread
    keeps the many small torch ops here from oversubscribing its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BF = torch.bfloat16
ENGINE_TOL = 1e-2
STEP_GRAD_REL = 2e-2
LOSS_TOL = dict(rtol=0.05, atol=0.02)
B, T, N = 3, 3, 40          # the engines' batch, the sequences, the nodes
GRNN_CASES = [(g, m) for g in (None, "time", "node")
              for m in ("dense", "band", "bcsr", "edge")]
GRNN_CASES += [("edge", "dense"), ("edge", "edge")]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jax_grnn_answer(ja, params, x, z0):
    """JAX's bf16 engine of batch B on the request (x, z0) (n <= B rows)."""
    eng = jserving.InferenceEngine(ja, params, (x, z0), batch_size=B,
                                   dtype=jnp.bfloat16)
    return np.asarray(eng(x, z0))


def _calls_by_name(dtype):
    return {name: n for (name, dt), n in kernels.OP_CALLS.items()
            if n and dt == dtype}


# ---------------------------------------------------------------------------
# The GRNNs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gate,mode", GRNN_CASES,
                         ids=[f"{g}-{m}" for g, m in GRNN_CASES])
def test_grnn_bf16_engine_matches_jax(gate, mode):
    """A ragged request (2 of B rows) to the bf16 engine against JAX's bf16
    engine on the same z0 (the port's draw for the padded batch, which the
    f32 engine draws too); the caller's model stays f32; in band and bcsr
    mode every shift is a bf16 call, as many as the f32 engine's."""
    S = _band_graph(N)
    ja, params, ta = _pair(gate, S, mode=mode,
                           jmode="edge" if mode == "edge" else "dense")
    x = np.random.default_rng(1).standard_normal((B, T, 2, N)).astype(
        np.float32)[:2]
    z0 = ta.draw_z0(B, N).numpy()[:2]
    engines = {dt: tserving.InferenceEngine(ta, B, device="cpu", dtype=dt)
               for dt in (None, BF)}
    calls = {}
    for dt, eng in engines.items():
        kernels.OP_CALLS.clear()
        y = eng(x)
        calls[dt] = (_calls_by_name(torch.float32 if dt is None else BF), y)
    got = calls[BF][1]
    assert got.dtype == torch.float32 and got.shape == (2, T, 3, N)
    want = _jax_grnn_answer(ja, params, x, z0)
    assert _rel(got, want) <= ENGINE_TOL
    assert _rel(got, calls[None][1]) <= ENGINE_TOL
    if mode in ("band", "bcsr"):
        assert calls[BF][0] and calls[BF][0] == calls[None][0]
    assert {p.dtype for p in ta.parameters()} == {torch.float32}
    if mode == "edge":
        assert ta.S.s_val.dtype == torch.float32


@pytest.mark.parametrize("gate", [None, "node"])
def test_sharded_grnn_bf16_engine_matches_jax(gate, monkeypatch):
    """A GRNN .shard()ed over a (1, 4) mesh of the CPU (the ring shift on
    its band kernel's plain version, forced as on the card) served in
    bf16: against JAX's bf16 engine (dense, unsharded) on the same z0 and
    against the port's unsharded bf16 engine; its shifts run on the
    ShardedGso's bf16 twin."""
    monkeypatch.setattr(tshift, "_uses_band_kernel", lambda *a: True)
    S = _band_graph(64)
    ja, params, ta = _pair(gate, S, mode="band", K=(2, 2), jmode="dense")
    x = np.random.default_rng(2).standard_normal((B, T, 2, 64)).astype(
        np.float32)
    unsharded = tserving.InferenceEngine(ta, B, device="cpu", dtype=BF)(x)
    ta.shard(tpar.make_mesh((1, 4), devices=[torch.device("cpu")] * 4), 4)
    assert isinstance(ta.S, tpar.ShardedGso) and ta.S.uses_ring
    kernels.OP_CALLS.clear()
    got = tserving.InferenceEngine(ta, B, device="cpu", dtype=BF)(x)
    assert _calls_by_name(BF).get("band_matmul", 0) > 0
    assert not _calls_by_name(torch.float32)
    want = _jax_grnn_answer(ja, params, x, ta.draw_z0(B, 64).numpy())
    assert _rel(got, want) <= ENGINE_TOL
    assert _rel(got, unsharded) <= ENGINE_TOL


def test_grnn_bf16_introspection_and_export():
    """cost_analysis, memory_analysis and export_model on a bf16 GRNN
    engine in edge mode: the flops of the f32 engine's forward, argument
    bytes of the bf16 request and parameters, and an exported program that
    answers bit-equal to the engine."""
    S = _band_graph(N)
    _, _, ta = _pair("node", S, mode="edge", jmode="edge")
    x = np.random.default_rng(3).standard_normal((B, T, 2, N)).astype(
        np.float32)
    eng = tserving.InferenceEngine(ta, B, device="cpu", dtype=BF,
                                   example_args=(x,))
    eng32 = tserving.InferenceEngine(ta, B, device="cpu", example_args=(x,))
    n_params = sum(p.numel() for p in ta.parameters())
    mem = eng.memory_analysis()
    assert mem.argument_size_in_bytes == 2 * (x.size + n_params)
    assert mem.output_size_in_bytes == 4 * B * T * 3 * N
    assert eng.cost_analysis()["flops"] == eng32.cost_analysis()["flops"] > 0
    blob = tserving.export_model(ta, (x,), dtype=BF, device="cpu")
    assert torch.equal(tserving.load_exported(blob)(x), eng(x))


# ---------------------------------------------------------------------------
# MultiNodeAggregationGNN and the attention family in edge mode
# ---------------------------------------------------------------------------

MULTI_N = 12
MULTI_ARGS = ([3, 2], [6, 5], [[1, 2], [3, 3], [2]], [[2], [2]], True,
              "relu", "NoPool", [[1], [1]], [4])


def test_multinode_aggregation_bf16_engine_matches_jax():
    """JAX's bf16 engine casts x to f32 against bf16 parameters; the port's
    computes in f32 on the bf16-rounded request and parameters, and keeps
    the parameters bf16 (its argument bytes); its export answers
    bit-equal."""
    S = _sbm(MULTI_N, 5)
    ja = jarch.MultiNodeAggregationGNN(*MULTI_ARGS, S)
    params = ja.init(jax.random.PRNGKey(1))
    ta = tarch.MultiNodeAggregationGNN(*MULTI_ARGS, S, device="cpu")
    load_flax_params(ta, _numpy_tree(params))
    x = np.random.default_rng(6).standard_normal((B, 1, MULTI_N)).astype(
        np.float32)
    eng = tserving.InferenceEngine(ta, B, device="cpu", dtype=BF,
                                   example_args=(x,))
    got = eng(x[:2])
    want = np.asarray(jserving.InferenceEngine(
        ja, params, (x[:2],), batch_size=B, dtype=jnp.bfloat16)(x[:2]))
    assert got.dtype == torch.float32 and _rel(got, want) <= ENGINE_TOL
    assert {p.dtype for p in ta.parameters()} == {torch.float32}
    assert {p.dtype for p in eng._served.parameters()} == {BF}
    n_params = sum(p.numel() for p in ta.parameters())
    assert eng.memory_analysis().argument_size_in_bytes == 2 * (
        x.size + n_params)
    blob = tserving.export_model(ta, (x,), dtype=BF, device="cpu")
    assert torch.equal(tserving.load_exported(blob)(x), eng(x))


@pytest.mark.parametrize("kind", list(ARCHS))
def test_edge_attention_bf16_engine_matches_jax(kind):
    """GAT, GCAT and EdgeVariantAttention in edge mode served in bf16 (the
    EdgeList's s_val cast) against JAX's bf16 engine."""
    cls_j, cls_t, args = ARCHS[kind]
    S = _edge_graph(N_ARCH, 1, seed=7)
    ja = cls_j(*args(S), attentionMode="edge")
    params = _init(ja, 1)
    ta = cls_t(*args(S), attentionMode="edge", device="cpu")
    load_flax_params(ta, _numpy_tree(params))
    x = np.random.default_rng(8).standard_normal((B, 2, N_ARCH)).astype(
        np.float32)
    eng = tserving.InferenceEngine(ta, B, device="cpu", dtype=BF)
    got = eng(x)
    assert eng._served.S.s_val.dtype == BF
    assert eng._served.S.row is ta.S.row
    want = np.asarray(jserving.InferenceEngine(ja, params, (x,),
                                               dtype=jnp.bfloat16)(x))
    assert got.dtype == torch.float32 and _rel(got, want) <= ENGINE_TOL


# ---------------------------------------------------------------------------
# Trainer(precision="bf16") on an EdgeList context
# ---------------------------------------------------------------------------

TRAIN_N, BATCH, N_SAMPLES = 48, 14, 42    # 3 even steps an epoch


def _fixed_z0(B_, H, N_):
    """The z0 of both test GRNNs below, fixed by the batch size: they draw
    none (the two packages' random generators differ)."""
    return np.random.default_rng(B_).standard_normal((B_, H, N_)).astype(
        np.float32)


class _JGrnn(jarch.GraphRecurrentNN):
    def split_forward(self, params, x, rng=None, z0=None):
        x = jnp.asarray(x)
        return super().split_forward(
            params, x, z0=jnp.asarray(_fixed_z0(x.shape[0], self.H,
                                                x.shape[-1])))


class _TGrnn(tarch.GraphRecurrentNN):
    def split_forward(self, x, generator=None, z0=None):
        x = torch.as_tensor(x)
        return super().split_forward(
            x, z0=_fixed_z0(x.shape[0], self.H, x.shape[-1]))


class _Regression(JData):
    """Seeded signals and targets of the given shapes, MSE evaluated."""

    def __init__(self, x_shape, y_shape, seed):
        super().__init__()
        rng = np.random.default_rng(seed)
        self.nTrain, self.nValid, self.nTest = N_SAMPLES, 10, 10
        for split, n in (("train", N_SAMPLES), ("valid", 10), ("test", 10)):
            self.samples[split]["signals"] = rng.standard_normal(
                (n,) + x_shape).astype(np.float32)
            self.samples[split]["targets"] = rng.standard_normal(
                (n,) + y_shape).astype(np.float32)

    def evaluate(self, yHat, y):
        return float(np.mean((np.asarray(yHat, np.float64) - y) ** 2))


def _train_case(kind):
    """(JAX architecture, its params, the port's on them, data, loss
    name): the GAT on an SBM's 0/1 adjacency (unit edge weights keep its
    activations near 1), the GRNN on the normalized SBM; seeded signals
    and targets, MSE."""
    if kind == "gat":
        S = (_sbm(TRAIN_N, 9) > 0).astype(np.float64)
        args = ([2, 8, 8], [2, 2], "relu", [TRAIN_N, TRAIN_N], "NoPool",
                [1, 1], [3], True, S)
        ja = jarch.GraphAttentionNetwork(*args, attentionMode="edge")
        params = _init(ja, 2)
        ta = tarch.GraphAttentionNetwork(*args, attentionMode="edge",
                                         device="cpu")
        data = _Regression((2, TRAIN_N), (3,), 10)
    else:
        S = _sbm(TRAIN_N, 9)
        args = (1, 2, 4, [2, 2], True, "tanh", "relu", "identity", [1], S)
        ja = _JGrnn(*args, gsoMode="edge")
        params = jax.jit(ja.core.init)(
            jax.random.PRNGKey(2), jnp.zeros((1, 2, 1, TRAIN_N)),
            jnp.zeros((1, 4, TRAIN_N)), ja.ctx)
        ta = _TGrnn(*args, gsoMode="edge", device="cpu")
        data = _Regression((T, 1, TRAIN_N), (T, 1, TRAIN_N), 11)
    load_flax_params(ta, _numpy_tree(params))
    assert isinstance(ta.S, tasp.EdgeList)
    return ja, params, ta, data


def _models(ja, params, ta, tmp_path):
    opt = {"name": "ADAM", "lr": 5e-3}
    ja.init = lambda key: params       # the jitted init's tree
    jm = jtrain.Model(ja, jtrain.losses.mse_loss, opt, jtrain.Trainer,
                      jtrain.evaluate, name="j", saveDir=str(tmp_path / "j"))
    tm = ttrain.Model(ta, ttrain.losses.mse_loss, opt, ttrain.Trainer,
                      ttrain.evaluate, name="t", saveDir=str(tmp_path / "t"))
    return jm, tm


@pytest.mark.parametrize("kind", ["gat", "grnn"])
def test_edge_list_bf16_trainer_matches_jax(kind, tmp_path):
    """The first bf16 step's gradients on the f32 masters against jax.grad
    of the JAX bf16 step's objective, then one epoch (3 steps) of losses
    against the JAX bf16 Trainer; the masters stay f32. The GRNN
    (compute_f32, on the f32 EdgeList) is held to JAX's bf16 gradients
    within STEP_GRAD_REL. The GAT computes in bf16 on the EdgeList's bf16
    twin, where the segment softmax's bf16 roundings move each framework's
    attention gradients 5-12% of max|g| from the f32 step's (measured on
    this model, JAX's too): each of its leaves is held to the JAX f32
    step's gradient within STEP_GRAD_REL, or within 1.5 times the distance
    of JAX's own bf16 gradient from it."""
    ja, params, ta, data = _train_case(kind)
    jm, tm = _models(ja, params, ta, tmp_path)
    jtr = jtrain.Trainer(jm, data, 1, BATCH, precision="bf16")
    ttr = ttrain.Trainer(tm, data, 1, BATCH, precision="bf16")
    if kind == "gat":
        assert ta.ctx_for_dtype(BF)["S"].s_val.dtype == BF
    idx = np.arange(BATCH)
    x, y = data.getSamples("train", idx)

    def jgrads(precision):
        def objective(p):
            pc, xc = jtr._mixed(p, jnp.asarray(x))
            return jm.loss(jtr._forward(pc, xc, None).astype(jnp.float32),
                           jnp.asarray(y))
        jtr.precision = precision
        return jax.value_and_grad(objective)(params)
    jloss, jg16 = jgrads("bf16")
    tloss, _ = ttr.train_batch(idx)
    np.testing.assert_allclose(tloss, float(jloss), **LOSS_TOL)
    if kind == "grnn":
        _assert_grads(ta.flax_names(), jg16, STEP_GRAD_REL)
    else:
        _, jg32 = jgrads(None)
        names = ta.flax_names()
        for (path, p, g16), (_, _, g32) in zip(
                _leaves_by_name(_numpy_tree(jg16), names),
                _leaves_by_name(_numpy_tree(jg32), names)):
            scale = np.abs(g32).max()
            jax_err = np.abs(g16 - g32).max() / scale
            err = np.abs(p.grad.double().numpy() - g32).max() / scale
            assert err <= max(STEP_GRAD_REL, 1.5 * jax_err), (path, err,
                                                              jax_err)

    ja2, params2, ta2, _ = _train_case(kind)
    jm, tm = _models(ja2, params2, ta2, tmp_path / "run")
    ja2._ctx_for_dtype(jnp.dtype(jnp.bfloat16))
    kw = dict(nEpochs=1, batchSize=BATCH, validationInterval=3,
              precision="bf16")
    jout = jm.train(data, **kw)
    tout = tm.train(data, **kw)
    assert len(tout["lossTrain"]) == 3
    np.testing.assert_allclose(tout["lossTrain"], jout["lossTrain"],
                               **LOSS_TOL)
    assert {p.dtype for p in ta2.parameters()} == {torch.float32}


# ---------------------------------------------------------------------------
# The EdgeList as a pytree
# ---------------------------------------------------------------------------

def test_edge_list_pytree_pads_and_casts_its_float_leaf():
    """Flattened to row, col and s_val with n_nodes as its context; the
    engine's cast and leaf-wise padding and cast_ctx keep row and col int64
    and n_nodes, cast s_val only, and share the integer tables."""
    S = _edge_graph(20, 2, seed=3)
    el = tasp.build_edge_list(S, device="cpu")
    leaves, spec = _pytree.tree_flatten(el)
    assert [t.dtype for t in leaves] == [torch.int64, torch.int64,
                                         torch.float32]
    back = _pytree.tree_unflatten(leaves, spec)
    assert isinstance(back, tasp.EdgeList) and back.n_nodes == 20
    (cast,) = tserving._inputs((el,), torch.device("cpu"), BF)
    padded = _pytree.tree_map(lambda t: tserving._pad(t, el.nnz + 2), cast)
    for got in (cast, padded):
        assert isinstance(got, tasp.EdgeList) and got.n_nodes == 20
        assert got.row.dtype == got.col.dtype == torch.int64
        assert got.s_val.dtype == BF
    assert torch.equal(padded.row[:el.nnz], el.row)
    assert int(padded.row[el.nnz:].abs().sum()) == 0
    ctx = tgso.cast_ctx(el, BF)
    assert ctx.row is el.row and ctx.col is el.col and ctx.n_nodes == 20
    assert torch.equal(ctx.s_val, el.s_val.to(BF))
    assert el.to(dtype=torch.float32) is el and el.to("cpu") is el
    assert ttrain.trainer._cast_floats(el, BF).s_val.dtype == BF
