#!/usr/bin/env python3
"""Where the port's bf16 GRNN and edge-list paths round differently from
the JAX package's, measured on the CPU (JAX on its CPU backend, the port's
kernels on their plain versions).

    python3 experiments/torch_bf16_rounding_cpu.py

Prints one JSON line a measurement, each distance as a share of the
largest magnitude of its reference:
  * edge_shift: one edge-list shift of random bf16 operands, the port's
    (segment sums accumulated in f32, rounded once) and JAX's (bf16
    segment_sum) against the exact f64 sum, at N = 64 and 512;
  * grnn_engine: the bf16 InferenceEngine of each GRNN (ungated, time,
    node and edge gates; dense, band, bcsr and edge mode) against JAX's
    bf16 engine on the same z0, and against the port's f32 engine (N =
    40, T = 3, H = 4);
  * edge_attention_engine: GAT, GCAT and EdgeVariantAttention in edge mode
    in bf16 against JAX's bf16 engine;
  * gat_edge_grads: a bf16 GAT step's first gradients in edge mode, the
    port's and JAX's, each against JAX's f32 gradients, and against each
    other (N = 48, 0/1 adjacency, MSE on seeded targets);
  * grnn_full_width: grnn_band_n4096's GRNNs (chip_smoke.py's `_grnn`:
    N = 4096, H = 12, K = 5, T = 8) at batch 20 in band mode, bf16
    against f32, overall and at each step.
"""

import json
import os
import pathlib
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(4)

import chip_smoke as cs  # noqa: E402
from graph_neural_networks_torch import serving as tserving  # noqa: E402
from graph_neural_networks_torch.ops import attention_sparse as tasp  # noqa: E402
from graph_neural_networks_torch.utils.params import load_flax_params  # noqa: E402
from graph_neural_networks_tpu import serving as jserving  # noqa: E402
from graph_neural_networks_tpu import training as jtrain  # noqa: E402
from graph_neural_networks_tpu.ops import attention_sparse as jasp  # noqa: E402
from tests import test_torch_bf16_grnn_edge as t24  # noqa: E402
from tests.test_torch_bf16_training import (_leaves_by_name,  # noqa: E402
                                            _numpy_tree)
from tests.test_torch_edge_attention import (ARCHS, N_ARCH,  # noqa: E402
                                             _init)
from tests.test_torch_edge_attention import _graph as edge_graph  # noqa: E402
from tests.test_torch_grnn import _band_graph, _pair  # noqa: E402

BF = torch.bfloat16
CPU = torch.device("cpu")


def emit(**kw):
    print(json.dumps(kw), flush=True)


def share(got, want, ref=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    ref = want if ref is None else np.asarray(ref, np.float64)
    return float(np.abs(got - want).max() / np.abs(ref).max())


def edge_shift():
    rng = np.random.default_rng(0)
    for N in (64, 512):
        S = edge_graph(N, 1, seed=3)
        te = tasp.build_edge_list(S, device="cpu")
        je = jasp.build_edge_list(S)
        v = torch.from_numpy(rng.standard_normal((4, 8, N)).astype(
            np.float32)).to(BF)
        c = torch.from_numpy(rng.standard_normal((4, te.nnz)).astype(
            np.float32)).to(BF)
        port = tasp.edge_shift(v, c, te).float().numpy()
        jax_ = np.asarray(jasp.edge_shift(
            jnp.asarray(v.float().numpy()).astype(jnp.bfloat16),
            jnp.asarray(c.float().numpy()).astype(jnp.bfloat16),
            je).astype(jnp.float32))
        exact = tasp.edge_shift(v.double(), c.double(), te).numpy()
        emit(measure="edge_shift", N=N, edges_per_node=te.nnz / N,
             port_vs_exact=share(port, exact),
             jax_vs_exact=share(jax_, exact),
             port_vs_jax=share(port, jax_, exact))


def grnn_engines():
    B, T, N = t24.B, t24.T, t24.N
    for gate, mode in t24.GRNN_CASES:
        ja, params, ta = _pair(gate, _band_graph(N), mode=mode,
                               jmode="edge" if mode == "edge" else "dense")
        x = np.random.default_rng(1).standard_normal((B, T, 2, N)).astype(
            np.float32)
        got = tserving.InferenceEngine(ta, B, device="cpu", dtype=BF)(x)
        f32 = tserving.InferenceEngine(ta, B, device="cpu")(x)
        z0 = ta.draw_z0(B, N).numpy()
        want = np.asarray(jserving.InferenceEngine(
            ja, params, (x, z0), dtype=jnp.bfloat16)(x, z0))
        emit(measure="grnn_engine", gate=gate, mode=mode,
             vs_jax_bf16=share(got, want), vs_port_f32=share(got, f32))


def edge_attention_engines():
    for kind, (cls_j, cls_t, args) in ARCHS.items():
        S = edge_graph(N_ARCH, 1, seed=7)
        ja = cls_j(*args(S), attentionMode="edge")
        params = _init(ja, 1)
        ta = cls_t(*args(S), attentionMode="edge", device="cpu")
        load_flax_params(ta, _numpy_tree(params))
        x = np.random.default_rng(8).standard_normal(
            (3, 2, N_ARCH)).astype(np.float32)
        got = tserving.InferenceEngine(ta, 3, device="cpu", dtype=BF)(x)
        want = np.asarray(jserving.InferenceEngine(
            ja, params, (x,), dtype=jnp.bfloat16)(x))
        emit(measure="edge_attention_engine", kind=kind,
             vs_jax_bf16=share(got, want))


def gat_edge_grads(tmp):
    grads = {}
    for prec in ("bf16", None):
        ja, params, ta, data = t24._train_case("gat")
        jm, tm = t24._models(ja, params, ta, pathlib.Path(tmp) / str(prec))
        jtr = jtrain.Trainer(jm, data, 1, t24.BATCH, precision=prec)
        ttr = t24.ttrain.Trainer(tm, data, 1, t24.BATCH, precision=prec)
        x, y = data.getSamples("train", np.arange(t24.BATCH))

        def objective(p):
            pc, xc = jtr._mixed(p, jnp.asarray(x))
            return jm.loss(jtr._forward(pc, xc, None).astype(jnp.float32),
                           jnp.asarray(y))
        jg = jax.grad(objective)(params)
        ttr.train_batch(np.arange(t24.BATCH))
        grads[prec] = {"/".join(map(str, path)): (p.grad.double().numpy(), w)
                       for path, p, w in _leaves_by_name(_numpy_tree(jg),
                                                         ta.flax_names())}
    for leaf, (port16, jax16) in grads["bf16"].items():
        jax32 = grads[None][leaf][1]
        emit(measure="gat_edge_grads", leaf=leaf,
             port_bf16_vs_jax_f32=share(port16, jax32),
             jax_bf16_vs_jax_f32=share(jax16, jax32),
             port_bf16_vs_jax_bf16=share(port16, jax16))


def grnn_full_width():
    S = cs.banded_graph(np.random.default_rng(0), 4096, 256, 0.05)
    B = 20
    x = np.random.default_rng(22).integers(
        0, 3, (B, cs.GRNN_T, 1, 4096)).astype(np.float32)
    for gate in cs.GRNN_GATES:
        arch = cs._grnn(S, "band", CPU, gate)
        y32 = tserving.InferenceEngine(arch, B, CPU)(x)
        y16 = tserving.InferenceEngine(arch, B, CPU, dtype=BF)(x)
        scale = y32.abs().max().item()
        emit(measure="grnn_full_width", gate=gate, batch=B,
             bf16_vs_f32=share(y16, y32),
             per_step=[(y16[:, t] - y32[:, t]).abs().max().item() / scale
                       for t in range(cs.GRNN_T)])


def main() -> int:
    edge_shift()
    grnn_engines()
    edge_attention_engines()
    with tempfile.TemporaryDirectory() as tmp:
        gat_edge_grads(tmp)
    grnn_full_width()
    return 0


if __name__ == "__main__":
    sys.exit(main())
