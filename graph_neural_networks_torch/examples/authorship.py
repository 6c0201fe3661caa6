"""Authorship attribution on a fused word-adjacency network (reference
examples/authorshipGNN.py), trained with the port.

Classifies excerpts as written by the author or not, on the graph obtained
by fusing the author's training-set WANs. Compares localized activations
(max, median) against a pointwise-ReLU Selection GNN
(authorshipGNN.py:170-317: F=[1,32], K=[5], lr 5e-3, 25 epochs, batch 20).
Without --dataDir (or without its authorshipData.mat) the corpus is
Authorship's synthetic fallback.

Run:  python -m graph_neural_networks_torch.examples.authorship
          [--quick] [--device cpu] [--dataDir PATH] [--epochs N]
"""

from __future__ import annotations

import numpy as np

from graph_neural_networks_torch.examples import _task


def _args(argv):
    ap = _task.parser(__doc__, "experiments/authorship")
    ap.add_argument("--author", default="poe")
    ap.add_argument("--dataDir", default=None,
                    help="directory containing authorshipData.mat")
    return ap.parse_args(argv)


def setup(args) -> _task.Task:
    from graph_neural_networks_torch import data as D
    from graph_neural_networks_torch import training as T
    from graph_neural_networks_torch.models import architectures as archs

    rng = np.random.default_rng(args.seed)
    data = D.Authorship(args.author, 0.8, 0.1, data_dir=args.dataDir, rng=rng)
    W = data.createGraph()
    N = W.shape[0]
    S = W / np.max(np.abs(np.linalg.eigvals(W)).real)
    data.expandDims()
    print(f"== Authorship ({args.author}): N={N}, "
          f"{data.nTrain}/{data.nValid}/{data.nTest} samples ==", flush=True)

    F, K = [1, 16] if args.quick else [1, 32], [5]
    nEpochs, batch = (10, 20) if args.quick else (25, 20)
    kHop = [2] if args.quick else [3]
    gen = _task.seeded(args.seed)
    kinds = ["plain", "max_local"] + ([] if args.quick else ["median_local"])
    names = {"plain": "SelGNN", "max_local": "MaxLocal",
             "median_local": "MedianLocal"}

    def build(kind):
        if kind == "plain":
            return lambda dev: archs.SelectionGNN(
                F, K, True, "relu", [N], "NoPool", [1], [2], S,
                order="Degree", device=dev, generator=gen())
        return lambda dev: archs.LocalActivationGNN(
            F, K, True, kind, kHop, [N], "NoPool", [1], [2], S,
            order="Degree", device=dev, generator=gen())
    models = [_task.ModelSpec(names[k], build(k), T.losses.cross_entropy_loss,
                              T.Trainer, T.evaluate, 5e-3, 10)
              for k in kinds]
    return _task.Task(data, models, args.epochs or nEpochs, batch)


def main(argv=None) -> dict:
    from graph_neural_networks_torch.utils.device import resolve_device
    args = _args(argv)
    dev = resolve_device(args.device)
    task = setup(args)
    with _task.save_dir(args.saveDir) as out:
        return _task.run_all(task, dev, out, "error rate")


if __name__ == "__main__":
    main()
