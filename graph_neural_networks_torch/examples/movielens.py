"""MovieLens-100k rating prediction at a target movie node (reference
examples/movieGNN.py), trained with the port.

Builds a movie-similarity graph from training ratings (Pearson-style
correlation, kNN-sparsified), then regresses the rating at the target
movie with a Selection GNN (global readout, ``Trainer``/``evaluate``) and
Local GNNs of one and two layers (per-node readout, ``TrainerSingleNode``/
``evaluate_single_node``: the loss at each sample's target node). Config of
the JAX example (movieGNN.py:70-80, 139-172): F=[1,64,32], K=[5,5], kNN=10,
smooth-L1 loss, ADAM 5e-3, 40 epochs, batch 5. Without --dataDir (or
without ml-100k's u.data in it) the dataset is MovieLens' synthetic
low-rank fallback.

Run:  python -m graph_neural_networks_torch.examples.movielens
          [--quick] [--device cpu] [--dataDir PATH] [--epochs N]
"""

from __future__ import annotations

import numpy as np

from graph_neural_networks_torch.examples import _task


def _args(argv):
    ap = _task.parser(__doc__, "experiments/movielens")
    ap.add_argument("--node", type=int, default=50,
                    help="target movie node (reference uses 50)")
    ap.add_argument("--dataDir", default=None,
                    help="directory containing ml-100k/u.data")
    ap.add_argument("--interpolate", action="store_true",
                    help="NN-interpolate missing ratings before training")
    return ap.parse_args(argv)


def setup(args) -> _task.Task:
    from graph_neural_networks_torch import data as D
    from graph_neural_networks_torch import training as T
    from graph_neural_networks_torch.models import architectures as archs

    rng = np.random.default_rng(args.seed)
    node = args.node if not args.quick else 25
    data = D.MovieLens("movie", node, 0.9, 0.1, data_dir=args.dataDir,
                       kNN=10, rng=rng)
    if args.interpolate:
        data.interpolateRatings()
    W = data.getGraph()
    N = W.shape[0]
    S = W / _task.max_eig(W)
    data.expandDims()
    print(f"== MovieLens: movie graph N={N}, target node {node}, "
          f"{data.nTrain}/{data.nValid}/{data.nTest} samples ==", flush=True)

    F, K = ([1, 16], [4]) if args.quick else ([1, 64, 32], [5, 5])
    nEpochs, batch = (15, 5) if args.quick else (40, 5)
    loss = T.losses.adapt_extra_dimension_loss(T.losses.smooth_l1_loss)
    gen = _task.seeded(args.seed)
    L = len(F) - 1
    models = []
    if not args.quick:
        # Selection GNN: global MLP -> scalar rating, plain Trainer
        models.append(_task.ModelSpec(
            "SelGNN", lambda dev: archs.SelectionGNN(
                F, K, True, "relu", [N] * L, "NoPool", [1] * L, [1], S,
                order="Degree", device=dev, generator=gen()),
            loss, T.Trainer, T.evaluate, 5e-3, 40))
    for name, layers in [("LocalGNN1Ly", 1)] + (
            [] if args.quick else [("LocalGNN2Ly", 2)]):
        models.append(_task.ModelSpec(
            name, lambda dev, n=layers: archs.LocalGNN(
                F[:n + 1], K[:n], True, "relu", [N] * n, "NoPool", [1] * n,
                [1], S, order="Degree", device=dev, generator=gen()),
            loss, T.TrainerSingleNode, T.evaluate_single_node, 5e-3, 40))
    return _task.Task(data, models, args.epochs or nEpochs, batch)


def main(argv=None) -> dict:
    from graph_neural_networks_torch.utils.device import resolve_device
    args = _args(argv)
    dev = resolve_device(args.device)
    task = setup(args)
    with _task.save_dir(args.saveDir) as out:
        return _task.run_all(task, dev, out, "RMSE")


if __name__ == "__main__":
    main()
