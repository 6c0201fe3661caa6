"""20NEWS word-graph document classification (reference
dataTools.py:4006-4533), trained with the port.

Classifies documents from word-frequency signals on a word co-occurrence
graph with a Selection GNN. Loads a preprocessed ``twentynews.npz``
(x_train, y_train, x_test, y_test, adjacency) from --dataDir when present;
otherwise TwentyNews' synthetic word-graph corpus.

Run:  python -m graph_neural_networks_torch.examples.twentynews
          [--quick] [--device cpu] [--dataDir PATH] [--epochs N]

Returns the one model's evaluation ({costBest, costLast}), as the JAX
driver does.
"""

from __future__ import annotations

import numpy as np

from graph_neural_networks_torch.examples import _task


def _args(argv):
    ap = _task.parser(__doc__, "experiments/twentynews")
    ap.add_argument("--dataDir", default=None,
                    help="directory containing twentynews.npz")
    return ap.parse_args(argv)


def setup(args) -> _task.Task:
    from graph_neural_networks_torch import data as D
    from graph_neural_networks_torch import training as T
    from graph_neural_networks_torch.models import architectures as archs
    from graph_neural_networks_torch.utils import graph as gt

    rng = np.random.default_rng(args.seed)
    data = D.TwentyNews(ratioValid=0.1, data_dir=args.dataDir, rng=rng)
    data.expandDims()
    W = np.asarray(data.adjacencyMatrix, np.float64)
    # kNN-sparsify like the reference's word graph
    if (np.abs(W) > 0).mean() > 0.2:
        W = gt.sparsify_graph(W, "NN", 10)
    S = W / _task.max_eig(W)
    N = S.shape[0]
    C = int(np.max(data.samples["train"]["targets"])) + 1
    print(f"== TwentyNews: N={N} words, {C} classes, "
          f"{data.nTrain}/{data.nValid}/{data.nTest} docs ==", flush=True)
    nEpochs, batch = (10, 20) if args.quick else (30, 50)
    gen = _task.seeded(args.seed)
    spec = _task.ModelSpec(
        "SelGNN20news", lambda dev: archs.SelectionGNN(
            [1, 32], [5], True, "relu", [N], "NoPool", [1], [C], S,
            order="Degree", device=dev, generator=gen()),
        T.losses.cross_entropy_loss, T.Trainer, T.evaluate, 1e-3, 10)
    return _task.Task(data, [spec], args.epochs or nEpochs, batch)


def main(argv=None) -> dict:
    from graph_neural_networks_torch.utils.device import resolve_device
    args = _args(argv)
    dev = resolve_device(args.device)
    task = setup(args)
    with _task.save_dir(args.saveDir) as out:
        res, _, seconds = _task.run(task.models[0], task, dev, out)
    print(f"test error rate: best {res['costBest']:.4f} "
          f"last {res['costLast']:.4f} ({seconds:.1f} s)", flush=True)
    return res


if __name__ == "__main__":
    main()
