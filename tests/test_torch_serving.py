"""PyTorch port, serving (ROADMAP item 2): InferenceEngine's ragged
requests, (x, S) requests for the DB family (S dense or an EllGso, padded
leaf by leaf), the introspection (cost_analysis, memory_analysis,
flops_per_sample) and export_model/load_exported, held against the JAX
package's serving.py on the CPU with the same weights (carried across by
load_flax_params). The JAX band/bcsr paths run their Pallas kernels in TPU
interpret mode.

Tolerances: an engine against the model's own apply within 1e-5 (the same
computation, padded); against JAX's engine within 1e-4 (f32 sums in
another order). Exported programs reload in a fresh process that has not
imported the model code and answer equal to the engine.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze
from jax.experimental.pallas import tpu as pltpu

from graph_neural_networks_torch import serving as tserving
from graph_neural_networks_torch.models import architectures as tarch
from graph_neural_networks_torch.models import architectures_time as tarcht
from graph_neural_networks_torch.ops import ell as tell
from graph_neural_networks_torch.utils.params import load_flax_params
from graph_neural_networks_tpu import serving as jserving
from graph_neural_networks_tpu.models import architectures as jarch
from graph_neural_networks_tpu.models import architectures_time as jarcht
from graph_neural_networks_tpu.ops import ell as jell
from tests.test_torch_db_family import (AGG_ARGS, AGG_KW, GRNN_ARGS, _JGrnn,
                                        _TGrnn, _jax_z0, _stack)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine: one intra-op thread
    keeps the many small torch ops here from oversubscribing its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL_SELF = dict(atol=1e-5, rtol=1e-5)
TOL_JAX = dict(atol=1e-4, rtol=1e-4)
N = 200          # the static models' nodes (ragged: 2 blocks of 128)
B = 4            # the engines' batch
SEL_ARGS = ([2, 16, 16], [5, 5], True, "relu", [N, N], "NoPool", [1, 1],
            [3])


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, unfreeze(params))


def _graph(seed=0):
    rng = np.random.default_rng(seed)
    S = rng.random((N, N)) * (rng.random((N, N)) < 0.05)
    S = (S + S.T) / 2
    return S / np.abs(np.linalg.eigvalsh(S)).max()


def _banded(seed=0, half=40):
    """A non-symmetric banded S (the band and bcsr modes' graph)."""
    rng = np.random.default_rng(seed)
    S = np.zeros((N, N))
    for i in range(N):
        js = np.clip(i + rng.integers(-half, half + 1, 4), 0, N - 1)
        S[i, js] = rng.random(4)
    np.fill_diagonal(S, 0)
    return S / np.abs(np.linalg.eigvals(S)).max()


def _selection(mode, S=None, seed=0):
    """The JAX SelectionGNN, its params, and the port's with them."""
    S = _graph() if S is None else S
    with pltpu.force_tpu_interpret_mode():
        ja = jarch.SelectionGNN(*SEL_ARGS, S, gsoMode=mode)
        params = ja.init(jax.random.PRNGKey(seed))
    ta = tarch.SelectionGNN(*SEL_ARGS, S, gsoMode=mode, device="cpu")
    load_flax_params(ta, _tree(params))
    return ja, params, ta


def _x(seed, n=B, F=2):
    return np.random.default_rng(seed).standard_normal((n, F, N)).astype(
        np.float32)


def test_ragged_requests_and_refusal():
    """n = B, a smaller n and 1 row: padded to the batch and sliced back,
    equal to the model's own forward; more than B rows raise."""
    _, _, ta = _selection("dense")
    eng = tserving.InferenceEngine(ta, B, device="cpu")
    x = _x(1)
    with torch.no_grad():
        want = ta.apply(torch.from_numpy(x)).numpy()
    for n in (B, 3, 1):
        y = eng(x[:n])
        assert y.shape == (n, 3) and y.dtype == torch.float32
        np.testing.assert_allclose(y.numpy(), want[:n], **TOL_SELF)
    with pytest.raises(ValueError, match="exceeds"):
        eng(_x(2, n=B + 1))


# ---------------------------------------------------------------------------
# The DB family: (x, S) requests
# ---------------------------------------------------------------------------

DB_N, DB_T, DB_DEG = 12, 3, 4


def _db_pair(kind):
    """(JAX net, its params, the port's net with them) of one DB
    architecture (the GRNN draws JAX's PRNGKey(0) z0 on both sides)."""
    if kind == "local":
        jnet = jarcht.LocalGNN_DB([6, 8], [3], True, "tanh", [2], 1)
        tnet = tarcht.LocalGNN_DB([6, 8], [3], True, "tanh", [2], 1,
                                  device="cpu")
    elif kind == "grnn":
        jnet, tnet = _JGrnn(*GRNN_ARGS), _TGrnn(*GRNN_ARGS, device="cpu")
    else:
        jnet = jarcht.AggregationGNN_DB(*AGG_ARGS, **AGG_KW)
        tnet = tarcht.AggregationGNN_DB(*AGG_ARGS, device="cpu", **AGG_KW)
    params = jnet.init(jax.random.PRNGKey(3), N=DB_N, T=DB_T)
    load_flax_params(tnet, _tree(params))
    return jnet, params, tnet


def _db_request(seed, graph):
    """(x, S) of B samples: numpy x (B, T, 6, N) and the graph stack as
    each package takes it (jax, port)."""
    S, idx, val = _stack(seed, (B, DB_T), DB_N, DB_DEG)
    x = np.random.default_rng(seed).standard_normal(
        (B, DB_T, 6, DB_N)).astype(np.float32)
    if graph == "dense":
        return x, S, S
    return (x, jell.EllGso(jnp.asarray(idx), jnp.asarray(val)),
            tell.EllGso(torch.from_numpy(idx), torch.from_numpy(val)))


def _rows(S, n):
    """The first n samples of a dense stack or an EllGso (either
    package's)."""
    if isinstance(S, np.ndarray):
        return S[:n]
    return type(S)(S.idx[:n], S.val[:n])


@pytest.mark.parametrize("graph", ["ell", "dense"])
@pytest.mark.parametrize("kind", ["local", "grnn", "agg"])
def test_db_requests_match_apply_and_jax(kind, graph):
    jnet, params, tnet = _db_pair(kind)
    x, jS, tS = _db_request(5, graph)
    with torch.no_grad():
        want = tnet.apply(torch.from_numpy(x),
                          tS if graph == "ell" else torch.from_numpy(tS))
    # JAX's engine calls the GRNN's core, which takes its z0 as an
    # argument (x, z0, S): the padded batch's PRNGKey(0) draw, as the port
    # draws it for the padded batch
    z0 = (np.asarray(_jax_z0(0, B, DB_N)),) if kind == "grnn" else ()
    jeng = jserving.InferenceEngine(jnet, params, (x, *z0, jS))
    teng = tserving.InferenceEngine(tnet, B, device="cpu")
    for n in (B, 3, 1):
        got = teng(x[:n], _rows(tS, n))
        assert got.shape == want[:n].shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want[:n].numpy(), **TOL_SELF)
        jwant = jeng(x[:n], *(z[:n] for z in z0), _rows(jS, n))
        np.testing.assert_allclose(got.numpy(), np.asarray(jwant), **TOL_JAX)
    with pytest.raises(ValueError, match="exceeds"):
        teng(np.concatenate([x, x[:1]]), _rows(tS, B))


# ---------------------------------------------------------------------------
# Introspection
# ---------------------------------------------------------------------------

def test_memory_analysis_matches_jax():
    """Argument bytes (the padded batch and the parameters) and output
    bytes equal JAX's compiled call's (50700 and 48 for this model); the
    temporaries are None on the CPU."""
    ja, params, ta = _selection("dense")
    x = _x(3)
    jm = jserving.InferenceEngine(ja, params, (x,)).memory_analysis()
    tm = tserving.InferenceEngine(ta, B, device="cpu",
                                  example_args=(x[:1],)).memory_analysis()
    assert tm.argument_size_in_bytes == jm.argument_size_in_bytes == 50700
    assert tm.output_size_in_bytes == jm.output_size_in_bytes == 48
    assert tm.temp_size_in_bytes is None


def _hand_flops(mode, S):
    """One sample's flops of the SEL_ARGS model by hand: per layer the
    K-1 shifts of G rows (dense: 2 N^2 a row; band and bcsr: the JAX
    CostEstimate, 2 bs^2 for every stored block a row meets), the tap
    contraction 2 N F K G, and the readout 2 F N 3."""
    from graph_neural_networks_torch.ops import spmm
    if mode == "dense":
        shift = 2 * N * N
    elif mode == "band":
        s_band, _ = spmm.dense_to_band(S, 128)
        shift = 2 * s_band.size
    else:
        shift = 2 * spmm.dense_to_bcsr(S, 128)[0].size
    F, K = SEL_ARGS[0], SEL_ARGS[1]
    total = 0
    for l in range(len(K)):
        total += (K[l] - 1) * F[l] * shift + 2 * N * F[l + 1] * K[l] * F[l]
    return total + 2 * F[-1] * N * 3


@pytest.mark.parametrize("mode", ["dense", "band", "bcsr"])
def test_flops_per_sample(mode):
    """Dense: within 1% of JAX's (its XLA count also has the adds and
    ReLUs) and equal to the hand count; band and bcsr: equal to the hand
    count from the kernels' CostEstimate formulas (JAX's interpret-mode
    figure counts the interpreter)."""
    S = _graph() if mode == "dense" else _banded()
    ja, params, ta = _selection(mode, S)
    eng = tserving.InferenceEngine(ta, B, device="cpu", example_args=(_x(4),))
    got = eng.flops_per_sample()
    assert got == _hand_flops(mode, S)
    cost = eng.cost_analysis()
    assert cost["flops"] == B * got and cost["bytes accessed"] > 0
    if mode == "dense":
        want = jserving.InferenceEngine(ja, params,
                                        (_x(4),)).flops_per_sample()
        assert abs(got - want) <= 0.01 * want


# ---------------------------------------------------------------------------
# export_model / load_exported
# ---------------------------------------------------------------------------

EXPORTS = ["select_band", "select_bcsr", "gat_band", "local_db_ell"]
DTYPES = {"f32": None, "bf16": torch.bfloat16}


def _export_case(name):
    """(the port's model, one request as a tuple of arguments)."""
    if name.startswith("select"):
        return _selection(name.split("_")[1], _banded())[2], (_x(6),)
    if name == "gat_band":
        arch = tarch.GraphAttentionNetwork(
            [2, 4, 4], [2, 2], "relu", [N, N], "NoPool", [1, 1], [3], True,
            _banded(), attentionMode="band", device="cpu",
            generator=torch.Generator().manual_seed(0))
        return arch, (_x(7),)
    _, _, tnet = _db_pair("local")
    x, _, tS = _db_request(8, "ell")
    return tnet, (x, tS)


_RELOAD = textwrap.dedent("""
    import sys
    import torch
    sys.path.insert(0, {repo!r})
    from graph_neural_networks_torch.serving import load_exported
    torch.set_num_threads(1)
    cases = torch.load({inputs!r}, weights_only=False)
    out = {{}}
    for key, (path, args) in cases.items():
        out[key] = load_exported(path)(*args)
    assert not any(m.startswith("graph_neural_networks_torch.models")
                   for m in sys.modules), "the model code was imported"
    torch.save(out, {outputs!r})
""")


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """Every case exported in f32 and bf16 and its engine's answer; then
    all reloaded and answered in one fresh process."""
    tmp = tmp_path_factory.mktemp("exported")
    cases, engine_out = {}, {}
    for name in EXPORTS:
        arch, args = _export_case(name)
        for tag, dtype in DTYPES.items():
            path = str(tmp / f"{name}_{tag}.pt2")
            blob = tserving.export_model(arch, args, path=path, dtype=dtype,
                                         device="cpu")
            assert isinstance(blob, bytes) and os.path.getsize(path) == len(
                blob)
            eng = tserving.InferenceEngine(arch, B, device="cpu", dtype=dtype)
            engine_out[name, tag] = eng(*args)
            cases[f"{name}_{tag}"] = (path, args)
    torch.save(cases, str(tmp / "inputs.pt"))
    script = _RELOAD.format(repo=REPO, inputs=str(tmp / "inputs.pt"),
                            outputs=str(tmp / "outputs.pt"))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    run = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    reloaded = torch.load(str(tmp / "outputs.pt"), weights_only=False)
    return engine_out, reloaded


@pytest.mark.parametrize("tag", list(DTYPES))
@pytest.mark.parametrize("name", EXPORTS)
def test_export_round_trip(exported, name, tag):
    engine_out, reloaded = exported
    got, want = reloaded[f"{name}_{tag}"], engine_out[name, tag]
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got, want)
