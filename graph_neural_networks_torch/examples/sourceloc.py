"""Source localization on an SBM graph (reference examples/sourceLocGNN.py),
trained with the port.

Trains Selection GNNs (Degree, EDS and SpectralProxies orderings, local
max pooling; one with Graclus coarsening) and an Aggregation GNN to tell
which community seeded a diffusion process. Config of the JAX example
(sourceLocGNN.py:116-176, 230-429): N=100, 5 communities, F=[1,32,32],
K=[5,5], pooling to [10,10], MLP->5, ADAM 1e-3. --config loads a typed
``ExperimentConfig`` JSON (``utils.config``), and the effective config is
written next to the run's outputs. --graphType FacebookEgo takes the
234-node ego graph from --fbDataDir, or FacebookEgo's SBM fallback.

Run:  python -m graph_neural_networks_torch.examples.sourceloc
          [--quick] [--device cpu] [--config PATH] [--epochs N]
"""

from __future__ import annotations

import copy
import os

import numpy as np

from graph_neural_networks_torch.examples import _task


def _args(argv):
    ap = _task.parser(__doc__, "experiments/sourceloc")
    ap.add_argument("--graphType", default="SBM",
                    choices=["SBM", "SmallWorld", "FacebookEgo"],
                    help="reference sourceLocGNN.py:67 graph variants")
    ap.add_argument("--fbDataDir", default=None,
                    help="directory containing facebookEgo234.pkl")
    ap.add_argument("--config", default=None,
                    help="load a typed ExperimentConfig JSON (overrides "
                         "graph/training knobs; utils.config)")
    ap.add_argument("--tMax", type=int, default=None,
                    help="diffusion horizon (default: reference 25)")
    ap.add_argument("--normalize", action="store_true",
                    help="per-node standardization of the signals")
    return ap.parse_args(argv)


def setup(args, out_dir=None) -> _task.Task:
    """The task; the effective config and hyperparameters are written to
    `out_dir` when it is given."""
    from graph_neural_networks_torch import data as D
    from graph_neural_networks_torch import training as T
    from graph_neural_networks_torch.models import architectures as archs
    from graph_neural_networks_torch.utils import graph as gt
    from graph_neural_networks_torch.utils import misc
    from graph_neural_networks_torch.utils.config import (
        ExperimentConfig, GraphConfig, ModelConfig, TrainingConfig)

    rng = np.random.default_rng(args.seed)
    if args.quick:
        N, C = 40, 4
        nTrain, nValid, nTest, nEpochs, batch = 1000, 120, 200, 60, 50
        F, K, pool, mlp = [1, 16, 16], [4, 4], [20, 10], [C]
    else:
        N, C = 100, 5
        nTrain, nValid, nTest, nEpochs, batch = 8000, 200, 200, 40, 100
        F, K, pool, mlp = [1, 32, 32], [5, 5], [10, 10], [C]
    graph_type = args.graphType
    if args.config:
        cfg = ExperimentConfig.load(args.config)
        N = cfg.graph.nNodes
        C = cfg.graph.options.get("nCommunities", C)
        graph_type = cfg.graph.graphType
        nEpochs = cfg.training.nEpochs
        batch = cfg.training.batchSize
        mk = cfg.model.kwargs
        F = mk.get("dimNodeSignals", F)
        K = mk.get("nFilterTaps", K)
        pool = mk.get("nSelectedNodes", pool)
        mlp = mk.get("dimLayersMLP", mlp)

    if graph_type == "FacebookEgo":
        # reference sourceLocGNN.py:558-640: the 234-node 2-community ego
        # graph; sources = one high-degree node per community
        W = D.FacebookEgo(data_dir=args.fbDataDir).getAdjacencyMatrix()
        N, C = W.shape[0], 2
        pool = [N // 2, N // 4]
        mlp = [C]
        G = gt.Graph("adjacency", N, {"adjacencyMatrix": W})
        print(f"== Source localization: FacebookEgo N={N}, {C} "
              f"communities ==", flush=True)
    elif graph_type == "SmallWorld":
        G = gt.Graph("SmallWorld", N, {"probEdge": 5.0 / N,
                                       "probRewiring": 0.1}, rng=rng)
        print(f"== Source localization: SmallWorld N={N} ==", flush=True)
    else:
        print(f"== Source localization: SBM N={N}, {C} communities ==",
              flush=True)
        G = gt.Graph("SBM", N, {"nCommunities": C, "probIntra": 0.8,
                                "probInter": 0.2}, rng=rng)
    G.compute_gft()
    S = G.W / np.max(np.diag(G.E).real)               # S = W / lambda_max
    sources = gt.compute_source_nodes(G.A, C)
    # tMax = 25 per the reference driver (sourceLocGNN.py:119)
    tMax = args.tMax or (25 if not args.quick else 8)
    data = D.SourceLocalization(G, nTrain, nValid, nTest, sources,
                                tMax=tMax, rng=rng, normalize=args.normalize)
    data.expandDims()
    if out_dir is not None:
        misc.write_var_values(f"{out_dir}/hyperparameters.txt", {
            "N": N, "C": C, "F": F, "K": K, "pool": pool})
        os.makedirs(out_dir, exist_ok=True)
        ExperimentConfig(
            name="sourceloc", seed=args.seed, saveDir=out_dir,
            graph=GraphConfig(graphType=graph_type, nNodes=N,
                              options={"nCommunities": C}),
            model=ModelConfig(architecture="SelectionGNN",
                              kwargs={"dimNodeSignals": F, "nFilterTaps": K,
                                      "nSelectedNodes": pool,
                                      "dimLayersMLP": mlp}),
            training=TrainingConfig(nEpochs=nEpochs, batchSize=batch,
                                    lr=1e-3),
        ).save(f"{out_dir}/config.json")

    gen = _task.seeded(args.seed)
    ce = T.losses.cross_entropy_loss
    models = []
    # Selection GNNs; poolingSize = the neighbourhood hops summarized at
    # each pooling stage (reference sourceLocGNN.py:253: [6, 8])
    alpha = [3, 3] if args.quick else [6, 8]
    for order in ["Degree"] if args.quick else ["Degree", "EDS",
                                                "SpectralProxies"]:
        models.append(_task.ModelSpec(
            f"SelGNN{order}", lambda dev, o=order: archs.SelectionGNN(
                F, K, True, "relu", pool, "MaxPoolLocal", alpha, mlp, S,
                order=o, device=dev, generator=gen()),
            ce, T.Trainer, T.evaluate, 1e-3, 20))
    # Graclus coarsening pooling (reference sourceLocGNN.py:318-340); the
    # matching draws from the task's rng where the JAX example builds it
    if not args.quick:
        crs_rng = copy.deepcopy(rng)
        models.append(_task.ModelSpec(
            "SelGNNcrs", lambda dev: archs.SelectionGNN(
                F, K, True, "relu", [0, 0], "MaxPoolLocal", [2, 2], mlp, S,
                coarsening=True, rng=copy.deepcopy(crs_rng), device=dev,
                generator=gen()),
            ce, T.Trainer, T.evaluate, 1e-3, 20))
    aggF, aggK = ([1, 8, 16], [3, 4]) if args.quick else ([1, 16, 32], [4, 8])
    models.append(_task.ModelSpec(
        "AggGNN", lambda dev: archs.AggregationGNN(
            aggF, aggK, True, "relu", "MaxPoolLocal", [2, 2], mlp, S,
            order="Degree", maxN=None, device=dev, generator=gen()),
        ce, T.Trainer, T.evaluate, 1e-3, 20))
    return _task.Task(data, models, args.epochs or nEpochs, batch)


def main(argv=None) -> dict:
    from graph_neural_networks_torch.utils.device import resolve_device
    args = _args(argv)
    dev = resolve_device(args.device)
    with _task.save_dir(args.saveDir) as out:
        task = setup(args, out)
        return _task.run_all(task, dev, out, "error rate")


if __name__ == "__main__":
    main()
