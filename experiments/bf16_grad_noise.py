#!/usr/bin/env python3
"""How far bf16 mixed precision alone moves a first training step's
gradients, on the CPU: band_n4096's SelectionGNN([1,64,64], [5,5])
(chip_smoke.py's banded_graph at N nodes, batch 32, seed-37 signals and
labels) in the JAX package (dense mode) and in the port (band mode, the
kernels' plain versions), each leaf's max|g_bf16 - g_f32| / max|g_f32|
under the Trainers' bf16 casts (JAX Trainer._mixed; the port's
Trainer._mixed).

    python3 experiments/bf16_grad_noise.py [N]     (default N = 1024)

Prints one JSON line. The reference for chip_smoke.py's bf16 gradient
check: it holds a bf16 step on the kernels to the bf16 step on the plain
versions, not to f32, since both frameworks' bf16 gradients lie this far
from their f32 ones.
"""

import json
import os
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from graph_neural_networks_torch import training as tt  # noqa: E402
import graph_neural_networks_torch.models.architectures as ta  # noqa: E402
from graph_neural_networks_torch.utils import params as tparams  # noqa: E402
from graph_neural_networks_tpu import training as jt  # noqa: E402
import graph_neural_networks_tpu.models.architectures as ja  # noqa: E402

ARGS = ([1, 64, 64], [5, 5], True, "relu")


def main() -> int:
    N = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    S = cs.banded_graph(np.random.default_rng(0), N, 256, 0.05)
    rng = np.random.default_rng(37)
    x = rng.standard_normal((32, 1, N)).astype(np.float32)
    y = rng.integers(0, 5, 32)
    tail = ([N, N], "NoPool", [1, 1], [5], S)
    jarch = ja.SelectionGNN(*ARGS, *tail)
    params = jarch.init(jax.random.PRNGKey(0))

    def jgrads(precision):
        tr = types.SimpleNamespace(precision=precision)

        def objective(p):
            pc, xc = jt.Trainer._mixed(tr, p, jnp.asarray(x))
            return jt.losses.cross_entropy_loss(
                jarch.split_forward(pc, xc)[0].astype(jnp.float32),
                jnp.asarray(y))
        leaves = jax.tree_util.tree_leaves_with_path(
            jax.grad(objective)(params))
        return {jax.tree_util.keystr(k): np.asarray(
            g.astype(jnp.float32), np.float64) for k, g in leaves}

    tarch = ta.SelectionGNN(*ARGS, *tail, gsoMode="band", device="cpu")
    tparams.load_flax_params(tarch, jax.tree_util.tree_map(np.asarray, params))

    def tgrads(precision):
        tr = types.SimpleNamespace(
            precision=precision, model=types.SimpleNamespace(archit=tarch))
        out = tt.Trainer._mixed(tr, tarch.split_forward, torch.from_numpy(x))
        loss = tt.losses.cross_entropy_loss(out[0].float(),
                                            torch.from_numpy(y))
        names = [n for n, _ in tarch.core.named_parameters()]
        return dict(zip(names, (g.double().numpy() for g in
                                torch.autograd.grad(
                                    loss, list(tarch.parameters())))))

    def shares(bf, f32):
        return {k: float(np.abs(bf[k] - f32[k]).max() / np.abs(f32[k]).max())
                for k in f32}
    print(json.dumps(dict(
        N=N, jax_dense=shares(jgrads("bf16"), jgrads(None)),
        port_band_plain=shares(tgrads("bf16"), tgrads(None)))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
