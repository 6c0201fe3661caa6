"""Transferability and robustness, with the port: train on one GSO,
deploy on a perturbed one (``changeGSO`` + ``edge_fail_sampling``).

Filter taps are polynomial coefficients of the GSO, so the same parameters
run on any graph (reference architectures.py:322-420 +
graphTools.py:1163). Here: train source localization on an SBM with a
per-node readout (class scores averaged over the nodes), then evaluate
zero-shot on copies of the graph with 5% and 15% of its edges failed at
random (the reference's robustness experiment); the JAX package's
examples/transfer.py. --quick (not in the JAX driver) shrinks the sample
counts and epochs, not the model.

Run:  python -m graph_neural_networks_torch.examples.transfer
          [--quick] [--device cpu] [--epochs N]
"""

from __future__ import annotations

import numpy as np
import torch

from graph_neural_networks_torch.examples import _task
from graph_neural_networks_torch.training.trainer import Trainer

C = 4
N = 40


def _args(argv):
    return _task.parser(__doc__, "experiments/transfer").parse_args(argv)


def _make_task(N, seed, sizes):
    from graph_neural_networks_torch import data as D
    from graph_neural_networks_torch.utils import graph as gt
    r = np.random.default_rng(seed)
    G = gt.Graph("SBM", N, {"nCommunities": C, "probIntra": 0.8,
                            "probInter": 0.2}, rng=r)
    G.compute_gft()
    S = G.W / np.max(np.diag(G.E).real)
    sources = gt.compute_source_nodes(G.A, C)
    data = D.SourceLocalization(G, *sizes, sources, tMax=8, rng=r)
    data.expandDims()
    return S, data


def node_ce_loss(yHat: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The per-node class scores (B, C, N) averaged over the nodes into
    (B, C) logits, then softmax cross entropy (graph classification with a
    per-node readout, the transferable formulation)."""
    return torch.nn.functional.cross_entropy(yHat.mean(-1), y.long())


def _error(yHat, y) -> float:
    logits = yHat.mean(-1)
    return float((np.argmax(logits, 1) != np.asarray(y)).mean())


def node_evaluate(model, data, **kwargs) -> dict:
    """costBest/costLast: the error rate of the node-averaged logits on
    the test split."""
    xTest, yTest = data.getSamples("test")
    out = {}
    for label in ("Best", "Last"):
        try:
            model.load(label)
        except FileNotFoundError:
            continue
        with torch.no_grad():
            yHat = model.archit.apply(xTest).cpu().numpy()
        out[f"cost{label}"] = _error(yHat, yTest)
    return out


class NodeTrainer(Trainer):
    """Trainer whose validation cost is the error rate of the
    node-averaged logits."""

    def _valid_cost(self) -> float:
        x, y = self.data.getSamples("valid")
        with torch.no_grad():
            yHat = self._forward(self._to_device(x, y)[0])
        return _error(yHat.cpu().numpy(), y)


def setup(args) -> _task.Task:
    from graph_neural_networks_torch.models import architectures as archs
    sizes = (300, 50, 100) if args.quick else (1500, 200, 400)
    S, data = _make_task(N, 1, sizes)
    gen = _task.seeded(args.seed)
    spec = _task.ModelSpec(
        "transfer", lambda dev: archs.LocalGNN(
            [1, 16, 16], [4, 4], True, "relu", [N, N], "NoPool", [1, 1], [C],
            S, order="Degree", device=dev, generator=gen()),
        node_ce_loss, NodeTrainer, node_evaluate, 1e-3, 15)
    return _task.Task(data, [spec], args.epochs or (5 if args.quick else 30),
                      50, S)


def main(argv=None) -> dict:
    from graph_neural_networks_torch.utils import graph as gt
    from graph_neural_networks_torch.utils.device import resolve_device
    args = _args(argv)
    dev = resolve_device(args.device)
    task = setup(args)
    with _task.save_dir(args.saveDir) as out:
        res, model, _ = _task.run(task.models[0], task, dev, out)
        results = {"clean": res["costBest"]}
        print(f"test error on training GSO:            "
              f"{results['clean']:.4f}", flush=True)
        # zero-shot on perturbed GSOs: same parameters, edges failed at
        # random
        for p_fail in (0.05, 0.15):
            W_fail = gt.edge_fail_sampling(task.S, p_fail,
                                           rng=np.random.default_rng(3))
            model.archit.changeGSO(W_fail)
            err = model.evaluate(task.data)["costBest"]
            results[f"fail{p_fail}"] = err
            print(f"zero-shot, {int(p_fail * 100):2d}% edges failed:         "
                  f"{err:.4f} (chance {1 - 1 / C:.2f})", flush=True)
    return results


if __name__ == "__main__":
    main()
