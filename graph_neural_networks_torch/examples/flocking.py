"""Decentralized flocking controllers (reference examples/flockingGNN.py),
trained with the port.

Imitation learning of a centralized expert: time-varying GNN controllers
that only use delayed neighbor information (unit-delay propagation),
trained with DAGger (flockingGNN.py:73-184, 247-383: 50 agents, F=[6,64],
K=[3], MSE on accelerations, lr 5e-4, 30 epochs, batch 20, DAGger
probExpert .993). ``Flocking(...)`` generates the dataset on the host,
``TrainerFlocking`` trains from its host store (or, --deviceStore, from
the device-resident one, recomputing each batch's supervision all pairs
on the device), and ``evaluate_flocking`` rolls the trained controllers
closed loop on the test split.

Run:  python -m graph_neural_networks_torch.examples.flocking
          [--quick] [--device cpu] [--nAgents N] [--ellDegree D]
          [--deviceStore]

The four controllers of the JAX example are trained: the linear local
filter (LocalFlt), the Local GNN (LocalGNN), the Aggregation GNN (AggGNN,
F = [6, 32], nExchanges 4) and the Graph RNN (GraphRNN, H = 64); --quick
keeps the JAX example's choice of models (LocalGNN, GraphRNN) at its
narrower widths. Checkpoints go to --saveDir, or to a temporary directory
removed at the end.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time

import numpy as np
import torch


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--saveDir", default=None)
    ap.add_argument("--nAgents", type=int, default=None,
                    help="override swarm size (default 50 full / 12 quick)")
    ap.add_argument("--ellDegree", type=int, default=None,
                    help="train and roll out on the O(N*deg) ELL layout; "
                         "also switches the rollouts' graph normalization "
                         "to power iteration")
    ap.add_argument("--deviceStore", action="store_true",
                    help="device-resident trajectory store: the batch "
                         "supervision is recomputed on the device; also "
                         "switches the rollouts' lambda to power iteration")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    from graph_neural_networks_torch import training as T
    from graph_neural_networks_torch.data.flocking import Flocking
    from graph_neural_networks_torch.models.architectures_time import (
        AggregationGNN_DB, GraphRecurrentNN_DB, LocalGNN_DB)
    from graph_neural_networks_torch.utils.device import resolve_device

    args = _args(argv)
    dev = resolve_device(args.device)
    if args.quick:
        nAgents, duration, dt = 12, 1.0, 0.1
        nTrain, nValid, nTest, nEpochs, batch = 40, 8, 8, 4, 10
        F, K, H = [6, 16], [3], 16
    else:
        nAgents, duration, dt = 50, 2.0, 0.01
        nTrain, nValid, nTest, nEpochs, batch = 400, 20, 20, 30, 20
        F, K, H = [6, 64], [3], 64
    if args.nAgents is not None:
        nAgents = args.nAgents
    print(f"== Flocking: {nAgents} agents, duration {duration}s ({dev}) ==",
          flush=True)
    t0 = time.perf_counter()
    data = Flocking(nAgents=nAgents, commRadius=2.0, repelDist=1.0,
                    nTrain=nTrain, nValid=nValid, nTest=nTest,
                    duration=duration, samplingTime=dt,
                    rng=np.random.default_rng(args.seed), device=dev)
    t_gen = time.perf_counter() - t0
    if args.ellDegree is not None:
        data.rollout_ell_degree = args.ellDegree
        data.rollout_lam_method = "power"
    if args.deviceStore:
        data.rollout_lam_method = "power"
    expert_cost = data.evaluate(vel=data.getData("vel", "test"))
    print(f"generation {t_gen:.1f} s; expert (centralized) cost: "
          f"{expert_cost:.4f}", flush=True)

    gen = torch.Generator().manual_seed(args.seed)
    models = [
        ("LocalFlt", lambda: LocalGNN_DB(F[:1] + [2], [K[0]], True,
                                         "identity", [2], 1, device=dev,
                                         generator=gen)),
        ("LocalGNN", lambda: LocalGNN_DB(F, K, True, "tanh", [2], 1,
                                         device=dev, generator=gen)),
        ("AggGNN", lambda: AggregationGNN_DB(
            [6, 16] if args.quick else [6, 32], [2], True, "tanh",
            "MaxPoolLocal", [2], [2], 1, nExchanges=4, device=dev,
            generator=gen)),
        ("GraphRNN", lambda: GraphRecurrentNN_DB(
            6, 2, H, [K[0], K[0]], True, "tanh", "identity", "identity",
            [2], 1, device=dev, generator=gen)),
    ]
    if args.quick:
        models = [m for m in models if m[0] in ("LocalGNN", "GraphRNN")]

    results = {}
    with tempfile.TemporaryDirectory(prefix="flocking_") as tmp:
        for name, build in models:
            model = T.Model(build(), T.losses.mse_loss,
                            {"name": "ADAM", "lr": 5e-4}, T.TrainerFlocking,
                            T.evaluate_flocking, name=name,
                            saveDir=args.saveDir or tmp)
            print(f"{name}: {model.nParameters} params; training "
                  "(DAGger)...", flush=True)
            t0 = time.perf_counter()
            out = model.train(data, nEpochs, batch, validationInterval=20,
                              probExpert=0.993, DAGgerType="randomEpoch",
                              ellDegree=args.ellDegree,
                              deviceStore=args.deviceStore, seed=args.seed)
            t_train = time.perf_counter() - t0
            res = model.evaluate(data)
            results[name] = dict(res, loss_first=float(out["lossTrain"][0]),
                                 loss_last=float(out["lossTrain"][-1]),
                                 best_valid=float(np.min(out["costValid"])),
                                 train_s=t_train)
            print(f"  closed-loop cost: best {res['costBestFull']:.4f} "
                  f"(end {res['costBestEnd']:.4f}), training {t_train:.1f} s",
                  flush=True)

    print("== summary ==")
    print(f"expert: {expert_cost:.4f}")
    for name, res in results.items():
        print(f"{name}: closed-loop cost {res['costBestFull']:.4f}")
    result = dict(device=str(dev), n_agents=nAgents, expert=expert_cost,
                  generation_s=t_gen, models=results)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
