"""Filter-family zoo on source localization, trained with the port: the
spectral, node- and edge-variant, ARMA, GCAT, edge-variant attention,
coarsened Selection GNN and multi-node aggregation architectures trained
on the same task, so that their behaviour and cost compare side by side
(the JAX package's examples/variants.py; the reference exercises these
variants across its papers). The attention models run in dense mode, as
in JAX.

Run:  python -m graph_neural_networks_torch.examples.variants
          [--quick] [--device cpu] [--epochs N]
"""

from __future__ import annotations

import copy

import numpy as np

from graph_neural_networks_torch.examples import _task


def _args(argv):
    return _task.parser(__doc__, "experiments/variants").parse_args(argv)


def setup(args) -> _task.Task:
    from graph_neural_networks_torch import data as D
    from graph_neural_networks_torch import training as T
    from graph_neural_networks_torch.models import architectures as archs
    from graph_neural_networks_torch.utils import graph as gt

    rng = np.random.default_rng(args.seed)
    N, C = (40, 4) if args.quick else (60, 4)
    nTrain, nEpochs, batch = (800, 20, 50) if args.quick else (3000, 30, 100)
    G = gt.Graph("SBM", N, {"nCommunities": C, "probIntra": 0.8,
                            "probInter": 0.2}, rng=rng)
    G.compute_gft()
    S = G.W / np.max(np.diag(G.E).real)
    sources = gt.compute_source_nodes(G.A, C)
    data = D.SourceLocalization(G, nTrain, nTrain // 8, nTrain // 8, sources,
                                tMax=8, rng=rng)
    data.expandDims()

    F, K = [1, 16], [4]
    gen = _task.seeded(args.seed)
    # the coarsened model's matching draws from the rng where JAX's does
    crs_rng = copy.deepcopy(rng)
    zoo = {
        "Spectral": lambda dev: archs.SpectralGNN(
            F, [N // 2], True, "relu", [N], "NoPool", [1], [C], S,
            device=dev, generator=gen()),
        "NodeVariant": lambda dev: archs.NodeVariantGNN(
            F, K, [10], True, "relu", [N], "NoPool", [1], [C], S,
            order="Degree", device=dev, generator=gen()),
        "EdgeVariant": lambda dev: archs.EdgeVariantGNN(
            F, K, [10], True, "relu", [N], "NoPool", [1], [C], S,
            order="Degree", device=dev, generator=gen()),
        "ARMA": lambda dev: archs.ARMAfilterGNN(
            F, [2], [3], True, "relu", [N], "NoPool", [1], [C], S, tMax=4,
            device=dev, generator=gen()),
        "GCAT": lambda dev: archs.GraphConvolutionAttentionNetwork(
            F, K, [2], True, "relu", [N], "NoPool", [1], [C], S,
            device=dev, generator=gen()),
        "EVAttention": lambda dev: archs.EdgeVariantAttention(
            F, [2], [2], True, "relu", [N], "NoPool", [1], [C], S,
            device=dev, generator=gen()),
        "SelGNNcoarse": lambda dev: archs.SelectionGNN(
            [1, 16, 16], [3, 3], True, "relu", [0, 0], "MaxPoolLocal",
            [2, 2], [C], S, coarsening=True, rng=copy.deepcopy(crs_rng),
            device=dev, generator=gen()),
        "MultiNodeAgg": lambda dev: archs.MultiNodeAggregationGNN(
            [4, 2], [8, 6], [[1, 8], [8, 16], [16]], [[3], [3]], True,
            "relu", "MaxPoolLocal", [[2], [2]], [C], S, order="Degree",
            device=dev, generator=gen()),
    }
    models = [_task.ModelSpec(name, build, T.losses.cross_entropy_loss,
                              T.Trainer, T.evaluate, 1e-3, 20)
              for name, build in zoo.items()]
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
