"""PyTorch port, bf16 mixed-precision training (ROADMAP item 1), held
against the JAX package's bf16 training on the CPU: the differentiable
shifts' bf16 gradients against JAX's custom VJPs in bf16 (kernel 9's and
FlashApply's, and the GAT's trainer: tests/test_torch_flash_bwd_bf16.py),
and ``Trainer``/``TrainerSingleNode``/``TrainerFlocking`` with
``precision="bf16"`` against the JAX trainers from the same weights
(carried across by load_flax_params) and batches. The JAX Pallas kernels
run in interpret mode (``pltpu.force_tpu_interpret_mode()``), and the JAX
band GAT on its flash kernels (``_use_flash`` forced, what it runs on its
own device) for its first-step gradients; the port runs the kernels'
plain versions.

Tolerances, with the bf16 ulp of v taken as 2^(floor(log2|v|) - 7):
  * the flash backward (bwd_plain against the JAX kernel): dv within 2
    ulps of the larger of the two values, taken at no less than 1e-3 of
    max|dv| (one rounding of an f32 sum taken in another order); da2 and
    the folded da1 (f32) within 1e-3 of their largest magnitude;
  * the bf16 gradients of FlashApply, BandShift and BcsrShift: within
    1e-2 of each gradient's largest magnitude (a bf16 rounding of f32 sums
    taken in another order, 2^-8 relative); BandRegister's Horner chain
    rounds once a tap: K ulps of max|dx|;
  * a trainer: the first step's gradients within 2e-2 of each leaf's
    largest magnitude; the losses of 3 Adam steps within rtol 0.05 and
    atol 0.02 (the JAX package's own bf16 bound, tests/test_training.py
    test_bf16_mixed_precision_training): bf16 rounds the activations and
    products of every layer, at other points in the two frameworks.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze
from jax.experimental.pallas import tpu as pltpu

from graph_neural_networks_torch import kernels
from graph_neural_networks_torch import parallel as tpar
from graph_neural_networks_torch import training as ttrain
from graph_neural_networks_torch.models import architectures as tarch
from graph_neural_networks_torch.models import architectures_time as tarcht
from graph_neural_networks_torch.ops import gso as tgso
from graph_neural_networks_torch.ops import spmm as tspmm
from graph_neural_networks_torch.utils.params import load_flax_params
from graph_neural_networks_tpu import training as jtrain
from graph_neural_networks_tpu.models import architectures as jarch
from graph_neural_networks_tpu.models import architectures_time as jarcht
from graph_neural_networks_tpu.ops import attention_band as jab
from graph_neural_networks_tpu.ops import attention_flash as jaf
from graph_neural_networks_tpu.ops import filters as jfilters
from graph_neural_networks_tpu.ops import gso as jgso
from graph_neural_networks_tpu.ops import spmm as jspmm
from tests.test_torch_training import _source_loc

BF = torch.bfloat16
DV_ULPS = 2
ULP_FLOOR = 1e-3
F32_REL = 1e-3
GRAD_REL = 1e-2
STEP_GRAD_REL = 2e-2
LOSS_TOL = dict(rtol=0.05, atol=0.02)
TRAIN_OPT = {"name": "ADAM", "lr": 5e-3}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine: one intra-op thread
    keeps the many small torch ops here from oversubscribing its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32), np.float64)


def _ulps(got, want, floor=ULP_FLOOR) -> float:
    """Largest |got - want| in bf16 ulps of the larger magnitude, taken at
    no less than `floor` of max|want|."""
    got, want = _f64(got), _f64(want)
    scale = np.maximum(np.maximum(np.abs(got), np.abs(want)),
                       floor * np.abs(want).max())
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(scale, 1e-30))) - 7)
    return float((np.abs(got - want) / ulp).max())


def _rel(got, want) -> float:
    """max|got - want| over max|want|."""
    got, want = _f64(got), _f64(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _bf(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF)


def _jbf(t: torch.Tensor):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _aux_bf16(aux):
    """A BandAux with its float fields in bf16 (its entry lists kept)."""
    return type(aux)(*(t.to(BF) if t.is_floating_point() else t
                       for t in aux))


def _jaux_bf16(jg, w):
    aux = jaf._auxes(jfilters._slab5(jg), w)[0]
    return jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), aux)


# ---------------------------------------------------------------------------
# The differentiable shifts in bf16: the backward on the transposed layouts
# ---------------------------------------------------------------------------

BS = 16


def _shift_case(N, half, R, seed):
    rng = np.random.default_rng(seed)
    S = np.zeros((N, N))
    for i in range(N):
        js = np.clip(i + rng.integers(-half, half + 1, 4), 0, N - 1)
        S[i, js] = rng.standard_normal(len(js))
    return S, _bf(rng.standard_normal((R, N))), rng


def _bf16_calls(name):
    return kernels.OP_CALLS[name, BF]


def test_band_shift_bf16_grad_matches_jax():
    N, R = 90, 6
    S, x, rng = _shift_case(N, 20, R, 1)
    ct = _bf(rng.standard_normal((R, N)))
    g = tgso.as_gso(S, "band", BS, device="cpu").to(dtype=BF)
    jg = jgso.as_gso(S, "band", BS)
    xt = x.clone().requires_grad_()
    y = tspmm.BandShift.apply(xt, g.s_band[0], g.s_band_t[0], N, g.band_w,
                              BS)
    kernels.OP_CALLS.clear()
    y.backward(ct)
    assert _bf16_calls("band_matmul") == 1 and xt.grad.dtype == BF
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda z: jspmm.band_shift(
            z, _jbf(g.s_band[0]), _jbf(g.s_band_t[0]), N, jg.band_w, BS, 8),
            _jbf(x))
        (want,) = vjp(_jbf(ct))
    assert want.dtype == jnp.bfloat16
    assert _rel(xt.grad, want) <= GRAD_REL


def test_bcsr_shift_bf16_grad_matches_jax():
    N, R = 96, 7
    S, x, rng = _shift_case(N, 20, R, 2)
    ct = _bf(rng.standard_normal((R, N)))
    g = tgso.as_gso(S, "bcsr", BS, device="cpu").to(dtype=BF)
    jg = jgso.as_gso(S, "bcsr", BS)
    assert g.blocks_t.dtype == BF and g.block_row_t.dtype == torch.int32
    xt = x.clone().requires_grad_()
    y = tspmm.BcsrShift.apply(xt, g.blocks[0], g.block_row, g.block_col,
                              g.blocks_t[0], g.block_row_t, g.block_col_t,
                              N, BS)
    kernels.OP_CALLS.clear()
    y.backward(ct)
    assert _bf16_calls("bcsr_matmul") == 1 and xt.grad.dtype == BF
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda z: jspmm.bcsr_shift(
            z, _jbf(g.blocks[0]), jg.block_row, jg.block_col,
            _jbf(g.blocks_t[0]), jg.block_row_t, jg.block_col_t, N, BS),
            _jbf(x))
        (want,) = vjp(_jbf(ct))
    assert _rel(xt.grad, want) <= GRAD_REL


@pytest.mark.parametrize("K", [2, 4])
def test_band_register_bf16_grad_matches_jax(K):
    """The register's Horner backward in bf16 (K-1 bf16 band_matmuls on the
    transposed slab, g[k] added in bf16 after each) against JAX's
    band_register VJP on the same bf16 values."""
    N, R = 90, 5
    S, x, rng = _shift_case(N, 30, R, K)
    ct = _bf(rng.standard_normal((K, R, N)))
    g = tgso.as_gso(S, "band", BS, device="cpu").to(dtype=BF)
    jg = jgso.as_gso(S, "band", BS)
    xt = x.clone().requires_grad_()
    z = tspmm.BandRegister.apply(xt, g.s_band[0], g.s_band_t[0], K, N,
                                 g.band_w, BS)
    assert z.dtype == BF
    kernels.OP_CALLS.clear()
    z.backward(ct)
    assert _bf16_calls("band_matmul") == K - 1 and xt.grad.dtype == BF
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda u: jspmm.band_register(
            u, _jbf(g.s_band[0]), _jbf(g.s_band_t[0]), K, N, jg.band_w, BS,
            8), _jbf(x))
        (want,) = vjp(_jbf(ct))
    assert _ulps(xt.grad, want, floor=1.0) <= K


# ---------------------------------------------------------------------------
# Trainer(precision="bf16") against the JAX bf16 Trainer
# ---------------------------------------------------------------------------

N_TRAIN = 150   # two 128-blocks (ragged) in band mode, w = 1
BATCH = 14      # 42 training samples: 3 even steps an epoch (no retrace)

TRAIN_ARCHS = {
    "selgnn_band": (jarch.SelectionGNN, tarch.SelectionGNN,
                    ([1, 4, 4], [3, 2], True, "relu", [N_TRAIN, N_TRAIN],
                     "NoPool", [1, 1], [3]), dict(gsoMode="band")),
    "selgnn_bcsr": (jarch.SelectionGNN, tarch.SelectionGNN,
                    ([1, 4, 4], [3, 2], True, "relu", [N_TRAIN, N_TRAIN],
                     "NoPool", [1, 1], [3]), dict(gsoMode="bcsr")),
    "selgnn_dense": (jarch.SelectionGNN, tarch.SelectionGNN,
                     ([1, 4, 4], [3, 2], True, "relu", [N_TRAIN, N_TRAIN],
                      "NoPool", [1, 1], [3]), dict(gsoMode="dense")),
    "gat_band": (jarch.GraphAttentionNetwork, tarch.GraphAttentionNetwork,
                 ([1, 4, 4], [2, 2], "relu", [N_TRAIN, N_TRAIN], "NoPool",
                  [1, 1], [3], True), dict(attentionMode="band")),
}


@pytest.fixture(scope="module")
def sbm_data():
    from graph_neural_networks_tpu import data as jdata
    from graph_neural_networks_tpu.utils import graph as jgt
    G, _, data = _source_loc(jgt, jdata, N_TRAIN, 5, n=(42, 10, 10))
    return G.W / np.max(np.abs(np.linalg.eigvalsh(G.W))), data


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, unfreeze(tree))


def _leaves_by_name(tree, names):
    """(path, torch parameter, JAX leaf in the port's layout) for every
    parameter."""
    from graph_neural_networks_torch.utils.params import _flatten
    leaves = dict(_flatten(tree.get("params", tree)))
    out = []
    for path, (p, transpose) in names.items():
        v = np.asarray(leaves[path], np.float64)
        if isinstance(transpose, tuple):
            v = np.transpose(v, transpose)
        elif transpose:
            v = v.T
        out.append((path, p, v))
    return out


def _assert_grads(names, jgrads, rel=STEP_GRAD_REL):
    """Each parameter's f32 master gradient within `rel` of the JAX leaf's
    largest magnitude."""
    for path, p, want in _leaves_by_name(_numpy_tree(jgrads), names):
        assert p.grad is not None and p.grad.dtype == torch.float32, path
        err = np.abs(p.grad.double().numpy() - want).max()
        assert err <= rel * max(np.abs(want).max(), 1e-12), (path, err)


def _warm_jax_ctx(arch):
    """Fill the JAX architecture's bf16 context memo outside jit: the JAX
    Trainer fills it inside its jitted step, so the memo holds that trace's
    tracers, and the retrace at an uneven last batch meets them
    (UnexpectedTracerError)."""
    arch._ctx_for_dtype(jnp.dtype(jnp.bfloat16))


def _jax_model(kind, S, tmp_path):
    jcls, _, args, kw = TRAIN_ARCHS[kind]
    return jtrain.Model(jcls(*args, S, **kw),
                        jtrain.losses.cross_entropy_loss, TRAIN_OPT,
                        jtrain.Trainer, jtrain.evaluate, name="j",
                        saveDir=str(tmp_path / "j"), seed=0)


def _port_model(kind, S, jparams, tmp_path):
    """The port's model on the JAX model's weights."""
    _, tcls, args, kw = TRAIN_ARCHS[kind]
    ta = tcls(*args, S, device="cpu", **kw)
    load_flax_params(ta, _numpy_tree(jparams))
    return ttrain.Model(ta, ttrain.losses.cross_entropy_loss, TRAIN_OPT,
                        ttrain.Trainer, ttrain.evaluate, name="t",
                        saveDir=str(tmp_path / "t"))


def _train_models(kind, S, tmp_path):
    jm = _jax_model(kind, S, tmp_path)
    return jm, _port_model(kind, S, jm.params, tmp_path)


def check_trainer(kind, sbm_data, tmp_path, monkeypatch):
    """The first step's gradients (a batch of BATCH) on the f32 masters
    against jax.grad of the JAX bf16 step's objective (the JAX band GAT on
    its flash kernels, ``_use_flash`` forced: what it runs on its own
    device), then 3 Adam steps (one epoch) in bf16 against the JAX bf16
    Trainer's losses (on its CPU path); the masters stay f32, and the step
    ran the bf16 instances (the ops' bf16 calls)."""
    S, data = sbm_data
    with pltpu.force_tpu_interpret_mode():
        jm, tm = _train_models(kind, S, tmp_path)
    jtr = jtrain.Trainer(jm, data, 1, BATCH, precision="bf16")
    ttr = ttrain.Trainer(tm, data, 1, BATCH, precision="bf16")
    idx = np.random.default_rng(0).permutation(data.nTrain)[:BATCH]
    x, y = data.getSamples("train", idx)

    def objective(p):
        pc, xc = jtr._mixed(p, jnp.asarray(x, jnp.float32))
        return jm.loss(jtr._forward(pc, xc, None).astype(jnp.float32),
                       jnp.asarray(y))
    with monkeypatch.context() as mp, pltpu.force_tpu_interpret_mode():
        mp.setattr(jab, "_use_flash", lambda: True)
        jloss, jgrads = jax.value_and_grad(objective)(jm.params)
    kernels.OP_CALLS.clear()
    tloss, _ = ttr.train_batch(idx)
    np.testing.assert_allclose(tloss, float(jloss), **LOSS_TOL)
    _assert_grads(tm.archit.flax_names(), jgrads)
    calls = {k for k, n in kernels.OP_CALLS.items() if n}
    if kind in ("selgnn_band", "selgnn_bcsr", "gat_band"):
        assert calls and all(dt == BF for _, dt in calls), calls

    tm2 = _port_model(kind, S, jm.params, tmp_path / "run")
    _warm_jax_ctx(jm.archit)
    kw = dict(nEpochs=1, batchSize=BATCH, validationInterval=3,
              precision="bf16")
    with pltpu.force_tpu_interpret_mode():
        jout = jm.train(data, **kw)
    tout = tm2.train(data, **kw)
    assert len(tout["lossTrain"]) == 3
    np.testing.assert_allclose(tout["lossTrain"], jout["lossTrain"],
                               **LOSS_TOL)
    assert {p.dtype for p in tm2.archit.parameters()} == {torch.float32}
    assert {str(a.dtype) for a in jax.tree_util.tree_leaves(jm.params)} \
        == {"float32"}
    for state in tm2.optimizer.state.values():
        assert all(t.dtype == torch.float32 for t in state.values()
                   if torch.is_tensor(t) and t.is_floating_point())


@pytest.mark.parametrize("kind", ["selgnn_band", "selgnn_bcsr",
                                  "selgnn_dense"])
def test_trainer_bf16_matches_jax(kind, sbm_data, tmp_path, monkeypatch):
    """A small SelectionGNN in band, bcsr and dense mode (the GAT's cell:
    tests/test_torch_flash_bwd_bf16.py): see check_trainer."""
    check_trainer(kind, sbm_data, tmp_path, monkeypatch)


def test_validation_runs_f32(sbm_data, tmp_path):
    """Validation runs the f32 forward, as the JAX Trainer's _valid_cost:
    the bf16 trainer's cost equals the f32 trainer's on the same
    weights."""
    S, data = sbm_data
    tm = _small_model(S, tmp_path, gsoMode="dense")
    bf = ttrain.Trainer(tm, data, 1, BATCH, precision="bf16")._valid_cost()
    f32 = ttrain.Trainer(tm, data, 1, BATCH)._valid_cost()
    assert bf == f32


def test_checkpoints_keep_f32_masters(sbm_data, tmp_path):
    """Best and Last of a bf16 run hold f32 parameters and optimizer
    state, and load back into the f32 masters."""
    S, data = sbm_data
    tm = _small_model(S, tmp_path, gsoMode="band")
    tm.train(data, nEpochs=1, batchSize=BATCH, validationInterval=1,
             precision="bf16")
    for label in ("Best", "Last"):
        blob = torch.load(tm._ckpt_path(label), weights_only=False)
        assert {t.dtype for t in blob["params"].values()} == {torch.float32}
        tm.load(label)
        assert {p.dtype for p in tm.archit.parameters()} == {torch.float32}


# ---------------------------------------------------------------------------
# The bf16 context memo
# ---------------------------------------------------------------------------

def test_change_gso_drops_the_bf16_context_memo(sbm_data):
    """ctx_for_dtype casts once and memoizes; changeGSO drops the memo, so
    a bf16 forward after it sees the new graph (the JAX package's
    test_bf16_ctx_cast_invalidated_by_changeGSO)."""
    S1, _ = sbm_data
    N = S1.shape[0]
    rng = np.random.default_rng(9)
    W2 = rng.random((N, N)) * (rng.random((N, N)) < 0.05)
    W2 = (W2 + W2.T) / 2
    S2 = W2 / np.max(np.abs(np.linalg.eigvalsh(W2)))
    arch = tarch.SelectionGNN([1, 8], [3], True, "relu", [N], "NoPool",
                              [1], [3], S1, gsoMode="band", device="cpu")
    ctx = arch.ctx_for_dtype(BF)
    assert arch.ctx_for_dtype(BF) is ctx and arch.ctx_for_dtype(
        torch.float32) is arch.ctx
    assert ctx["S"].s_band_t.dtype == BF and ctx["S"].S.dtype == BF
    x = _bf(rng.standard_normal((4, 1, N)))
    _, mixed = _mixed_pair(None, arch)     # bf16 casts of the parameters
    with torch.no_grad():
        y1 = mixed(arch.apply, x).float()
        arch.changeGSO(S2)
        assert arch.ctx_for_dtype(BF) is not ctx
        y2 = mixed(arch.apply, x).float()
        y2_f32 = arch.apply(x.float())
    assert (y2 - y1).abs().max() > 1e-4, "bf16 forward ignored changeGSO"
    np.testing.assert_allclose(y2.numpy(), y2_f32.numpy(), rtol=0.1,
                               atol=0.05)


# ---------------------------------------------------------------------------
# Architectures whose forward computes in f32: bf16-rounded parameters
# ---------------------------------------------------------------------------

def _mixed_pair(ja, ta):
    """The two trainers' bf16 _mixed, on stand-ins for the trainers."""
    jtr = types.SimpleNamespace(precision="bf16")
    ttr = types.SimpleNamespace(
        precision="bf16", model=types.SimpleNamespace(archit=ta))
    return (lambda *a: jtrain.Trainer._mixed(jtr, *a),
            lambda *a, **kw: ttrain.Trainer._mixed(ttr, *a, **kw))


def _sbm(N, seed):
    rng = np.random.default_rng(seed)
    W = rng.random((N, N)) * (rng.random((N, N)) < 0.2)
    W = (W + W.T) / 2
    np.fill_diagonal(W, 0)
    return W / np.max(np.abs(np.linalg.eigvalsh(W)))


def test_grnn_bf16_params_f32_activations_match_jax():
    """GraphRecurrentNN under bf16 mixed precision: JAX casts x to f32 and
    passes the f32 context, so its arithmetic is f32 on bf16-rounded
    parameters; the port's output stays f32 and its master gradients match
    JAX's (a bf16 cotangent rounding on each parameter, as JAX's)."""
    N, B, T = 20, 3, 4
    S = _sbm(N, 3)
    args = (2, 3, 4, [3, 2], True, "tanh", "relu", "identity", [3], S)
    ja = jarch.GraphRecurrentNN(*args)
    params = ja.init(jax.random.PRNGKey(0))
    ta = tarch.GraphRecurrentNN(*args, device="cpu")
    load_flax_params(ta, _numpy_tree(params))
    assert ta.compute_f32
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, T, 2, N)).astype(np.float32)
    z0 = rng.standard_normal((B, 4, N)).astype(np.float32)
    jmix, tmix = _mixed_pair(ja, ta)

    def jloss(p):
        pc, xc = jmix(p, jnp.asarray(x))
        y = ja.split_forward(pc, xc, z0=jnp.asarray(z0))[0]
        return jnp.mean(y.astype(jnp.float32) ** 2), y
    (_, jy), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    y = tmix(ta.split_forward, torch.from_numpy(x), z0=z0)[0]
    assert y.dtype == torch.float32 and jy.dtype == jnp.float32
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=1e-4, atol=1e-5)
    torch.mean(y ** 2).backward()
    _assert_grads(ta.flax_names(), jgrads)


def test_multinode_aggregation_bf16_params_f32_activations_match_jax():
    """MultiNodeAggregationGNN under bf16 mixed precision: its apply casts
    x to f32 against bf16 parameters in JAX, f32 arithmetic on
    bf16-rounded parameters in the port."""
    N = 12
    S = _sbm(N, 5)
    args = ([3, 2], [6, 5], [[1, 2], [3, 3], [2]], [[2], [2]], True,
            "relu", "NoPool", [[1], [1]], [4], S)
    ja = jarch.MultiNodeAggregationGNN(*args)
    params = ja.init(jax.random.PRNGKey(1))
    ta = tarch.MultiNodeAggregationGNN(*args, device="cpu")
    load_flax_params(ta, _numpy_tree(params))
    x = np.random.default_rng(6).standard_normal((3, 1, N)).astype(
        np.float32)
    jmix, tmix = _mixed_pair(ja, ta)

    def jloss(p):
        pc, xc = jmix(p, jnp.asarray(x))
        y = ja.split_forward(pc, xc)[0]
        return jnp.mean(y.astype(jnp.float32) ** 2), y
    (_, jy), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    y = tmix(ta.split_forward, torch.from_numpy(x))[0]
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=1e-4, atol=1e-5)
    torch.mean(y ** 2).backward()
    _assert_grads(ta.flax_names(), jgrads)


# ---------------------------------------------------------------------------
# TrainerSingleNode and TrainerFlocking in bf16
# ---------------------------------------------------------------------------

def test_single_node_bf16_matches_jax(tmp_path):
    """TrainerSingleNode(precision='bf16') on a small synthetic MovieLens
    graph (bcsr mode in the port, dense in JAX): the first step's
    gradients and one epoch's losses."""
    from graph_neural_networks_torch import data as tdata
    from graph_neural_networks_tpu import data as jdata
    from tests.test_torch_single_node import BATCH as SN_BATCH
    from tests.test_torch_single_node import _models as sn_models
    from tests.test_torch_single_node import _movielens
    from tests.test_torch_single_node import ML
    M = tdata.MovieLens._synthesize(np.random.default_rng(0),
                                    ML["nSynthUsers"], ML["nSynthMovies"])
    for lid in np.argsort(-(M > 0).sum(0), kind="stable"):
        try:
            td = _movielens(tdata, int(lid))
            break
        except ValueError:
            continue
    jd = _movielens(jdata, int(lid))
    W = td.getGraph()
    S = W / np.max(np.abs(np.linalg.eigvalsh(W)))
    jm, tm = sn_models(S, "bcsr", tmp_path)
    jtr = jtrain.TrainerSingleNode(jm, jd, 1, SN_BATCH, precision="bf16")
    ttr = ttrain.TrainerSingleNode(tm, td, 1, SN_BATCH, precision="bf16")
    idx = np.random.default_rng(0).permutation(td.nTrain)[:SN_BATCH]
    x, y, pos = jtr._train_batch_data(idx)
    arch = jm.archit

    def objective(p):
        pc, xc = jtr._mixed(p, jnp.asarray(x, jnp.float32))
        y_all = arch.core.apply(pc, xc, arch._ctx_for_dtype(xc.dtype))[0]
        yhat = y_all[jnp.arange(y_all.shape[0]), :, pos]
        return jm.loss(yhat.astype(jnp.float32), jnp.asarray(y))
    jloss, jgrads = jax.value_and_grad(objective)(jm.params)
    kernels.OP_CALLS.clear()
    tloss, _ = ttr.train_batch(idx)
    assert kernels.OP_CALLS["bcsr_matmul", BF] > 0
    assert kernels.OP_CALLS["bcsr_matmul", torch.float32] == 0
    np.testing.assert_allclose(tloss, float(jloss), **LOSS_TOL)
    _assert_grads(tm.archit.flax_names(), jgrads)
    jm2, tm2 = sn_models(S, "bcsr", tmp_path / "run", layers=1)
    _warm_jax_ctx(jm2.archit)
    kw = dict(nEpochs=1, batchSize=SN_BATCH, validationInterval=3,
              precision="bf16")
    jout = jm2.train(jd, **kw)
    tout = tm2.train(td, **kw)
    np.testing.assert_allclose(tout["lossTrain"], jout["lossTrain"],
                               **LOSS_TOL)
    assert {p.dtype for p in tm2.archit.parameters()} == {torch.float32}


FLOCK_HOST = dict(nAgents=10, commRadius=2.0, repelDist=1.0, nTrain=2,
                  nValid=1, nTest=1, duration=0.5, samplingTime=0.1)
FLOCK_GRID = dict(commRadius=2.0, repelDist=1.0, nTrain=2, nValid=1,
                  nTest=1, duration=0.5, samplingTime=0.1, ell_degree=16)
DB_ARGS = ([6, 8], [2], True, "tanh", [2], 1)


@pytest.mark.parametrize("store", ["host", "device"])
def test_trainer_flocking_bf16_matches_jax(store, tmp_path):
    """TrainerFlocking(precision='bf16') with LocalGNN_DB over the host
    store and a small grid device store: the supervision recomputed in
    f32, the learning step in bf16 (x, and the ELL graphs' val, in bf16;
    idx kept); two steps' losses against the JAX bf16 trainer's, f32
    masters after."""
    from graph_neural_networks_torch.data import flocking as tF
    from graph_neural_networks_tpu.data import flocking as jF
    if store == "host":
        jd = jF.Flocking(rng=np.random.default_rng(9), **FLOCK_HOST)
        td = tF.Flocking(rng=np.random.default_rng(9), device="cpu",
                         **FLOCK_HOST)
        kw, N = {}, 10
    else:
        jd = jF.Flocking.large_device(32, rng=np.random.default_rng(10),
                                      **FLOCK_GRID)
        td = tF.Flocking.large_device(32, rng=np.random.default_rng(10),
                                      device="cpu", **FLOCK_GRID)
        for split in ("train", "valid", "test"):    # one store for both
            td.pos[split] = torch.from_numpy(np.asarray(jd.pos[split]))
            td.vel[split] = torch.from_numpy(np.asarray(jd.vel[split]))
        kw, N = dict(deviceStore=True, ellDegree=16), 32
    jm = jtrain.Model(jarcht.LocalGNN_DB(*DB_ARGS), jtrain.losses.mse_loss,
                      {"name": "ADAM", "lr": 5e-3}, jtrain.TrainerFlocking,
                      jtrain.evaluate_flocking, name="j",
                      saveDir=str(tmp_path / "j"), N=N, T=3, seed=3)
    ta = tarcht.LocalGNN_DB(*DB_ARGS, device="cpu")
    load_flax_params(ta, _numpy_tree(jm.params))
    tm = ttrain.Model(ta, ttrain.losses.mse_loss, {"name": "ADAM",
                                                    "lr": 5e-3},
                      ttrain.TrainerFlocking, ttrain.evaluate_flocking,
                      name="t", saveDir=str(tmp_path / "t"))
    run = dict(nEpochs=1, batchSize=1, validationInterval=10, seed=4,
               precision="bf16", **kw)
    jout = jm.train(jd, **run)
    tout = tm.train(td, **run)
    assert len(tout["lossTrain"]) == 2
    np.testing.assert_allclose(tout["lossTrain"], jout["lossTrain"],
                               **LOSS_TOL)
    assert {p.dtype for p in ta.parameters()} == {torch.float32}


@pytest.mark.parametrize("E,G", [(1, 5), (2, 3)])
def test_ell_shift_rows_bf16_matches_jax(E, G):
    """EllShiftRows on bf16 signal rows and a bf16 val (idx kept): the
    forward and the backward's bf16 index_add_ against the JAX gather and
    its VJP's scatter-add in bf16, within 1e-2 of their largest
    magnitude."""
    from graph_neural_networks_torch.ops import ell as tell
    from graph_neural_networks_tpu.ops import ell as jell
    from tests.test_torch_ell import _stack
    B, N = 3, 20
    S = _stack(1, (B,), E, N)
    j = jell.ell_from_dense(S)
    jb = jell.EllGso(j.idx, jnp.asarray(j.val).astype(jnp.bfloat16))
    t = tell.EllGso(torch.tensor(np.asarray(j.idx)), _jax_to_bf(jb.val))
    rng = np.random.default_rng(2)
    xr = _bf(rng.normal(size=(B, N, E, G)))
    gy = _bf(rng.normal(size=(B, N, E, G)))
    xt = xr.clone().requires_grad_()
    y = tell.ell_shift_rows(xt, t)
    y.backward(gy)
    want, vjp = jax.vjp(lambda x: jell.ell_shift_rows(x, jb), _jbf(xr))
    (jgx,) = vjp(_jbf(gy))
    assert y.dtype == xt.grad.dtype == BF and jgx.dtype == jnp.bfloat16
    assert _rel(y, want) <= GRAD_REL
    assert _rel(xt.grad, jgx) <= GRAD_REL


def _jax_to_bf(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jnp.asarray(a).astype(
        jnp.float32))).to(BF)


def test_trainer_flocking_casts_the_ell_values_only():
    """The learning step's bf16 cast of a batch: x and an EllGso's val in
    bf16, its idx kept (JAX's _mixed over the EllGso pytree)."""
    from graph_neural_networks_torch.ops.ell import EllGso
    from graph_neural_networks_torch.training.trainer import _cast_floats
    ell = EllGso(torch.zeros((1, 2, 3, 4), dtype=torch.int32),
                 torch.ones((1, 2, 1, 3, 4)))
    x, S = _cast_floats((torch.ones(2), ell), BF)
    assert x.dtype == BF and S.val.dtype == BF
    assert S.idx.dtype == torch.int32


# ---------------------------------------------------------------------------
# The refusals that stay
# ---------------------------------------------------------------------------

def _small_model(S, d, **kw):
    arch = tarch.SelectionGNN([1, 4], [3], True, "relu", [S.shape[0]],
                              "NoPool", [1], [3], S, device="cpu", **kw)
    return ttrain.Model(arch, ttrain.losses.cross_entropy_loss,
                        {"name": "ADAM", "lr": 5e-3}, ttrain.Trainer,
                        ttrain.evaluate, name="m", saveDir=str(d))


def test_sharded_bf16_training_raises_naming_2_1(sbm_data, tmp_path):
    """Named when bf16 training of a sharded model was refused (ROADMAP
    item 2.1); now its parity: a band SelectionGNN sharded over a (1, 2)
    mesh trains under precision='bf16' (the ring shift on its bf16 twin),
    its first-step gradients on the f32 masters within STEP_GRAD_REL of
    each leaf's largest magnitude of the unsharded bf16 step's, and 3
    steps' losses within LOSS_TOL of the JAX sharded model's bf16
    Trainer(mesh=...) from the same weights."""
    from graph_neural_networks_tpu import parallel as jpar
    S, data = sbm_data
    mesh = tpar.make_mesh((1, 2), devices=[torch.device("cpu")] * 2)
    jmesh = jpar.make_mesh((1, 2), devices=jax.devices()[:2])
    with pltpu.force_tpu_interpret_mode():
        jm = _jax_model("selgnn_band", S, tmp_path)
    jm.archit.shard(jmesh, 2)
    _warm_jax_ctx(jm.archit)
    grads = []
    for shard in (False, True):
        tm = _port_model("selgnn_band", S, jm.params, tmp_path / str(shard))
        if shard:
            tm.archit.shard(mesh, 2)
        ttrain.Trainer(tm, data, 1, BATCH, precision="bf16").train_batch(
            np.arange(BATCH))
        grads.append([p.grad.double() for p in tm.archit.parameters()])
    for g, g0 in zip(*reversed(grads)):
        assert (g - g0).abs().max() <= STEP_GRAD_REL * max(
            g0.abs().max().item(), 1e-12)
    kw = dict(nEpochs=1, batchSize=BATCH, validationInterval=3,
              precision="bf16")
    with jmesh, pltpu.force_tpu_interpret_mode():
        jout = jm.train(data, mesh=jmesh, **kw)
    tm = _port_model("selgnn_band", S, jm.params, tmp_path / "run")
    tm.archit.shard(mesh, 2)
    tout = tm.train(data, mesh=mesh, **kw)
    assert len(tout["lossTrain"]) == 3
    np.testing.assert_allclose(tout["lossTrain"], jout["lossTrain"],
                               **LOSS_TOL)
    assert {p.dtype for p in tm.archit.parameters()} == {torch.float32}


def test_edge_list_bf16_training_raises_naming_2_2(sbm_data, tmp_path):
    """Named when bf16 training of an edge-list context was refused (ROADMAP
    item 2.2); now it trains: the bf16 context holds the EdgeList with its
    s_val in bf16 (row and col shared), and a step's gradients reach the
    f32 masters, finite. Parity with JAX's bf16 Trainer:
    tests/test_torch_bf16_grnn_edge.py."""
    S, data = sbm_data
    m = _small_model(S, tmp_path, gsoMode="edge")
    trainer = ttrain.Trainer(m, data, 1, 8, precision="bf16")
    edges, cast = m.archit.ctx["S"], m.archit.ctx_for_dtype(BF)["S"]
    assert cast.s_val.dtype == BF and edges.s_val.dtype == torch.float32
    assert cast.row is edges.row and cast.col is edges.col
    loss, _ = trainer.train_batch(np.arange(8))
    assert np.isfinite(loss)
    for p in m.archit.parameters():
        assert p.dtype == p.grad.dtype == torch.float32
        assert bool(torch.isfinite(p.grad).all())
