"""Large-swarm transfer: train the LocalGNN_DB flocking controller on one
swarm, deploy it closed loop on a much bigger one (the port of the JAX
package's ``examples/largeswarm.py``).

Three training modes, each with DAGger (randomEpoch, probExpert 0.993):

* standard (the default): ``Flocking(...)`` generates the reference-scale
  dataset on the host and ``TrainerFlocking`` trains from its host store;
* ``--largeTrain``: ``Flocking.large`` generates the expert's supervision
  on the cell grid, or with ``--no-envGrid`` on the chunked all-pairs env
  (states, labels and ELL graphs of width --ellDegree, kept as host numpy),
  and ``TrainerFlocking`` trains from that host store, its re-rolls,
  relabels and validation on the same env;
* ``--deviceStore``: ``Flocking.large_device`` keeps only the expert's
  (pos, vel) on the device and ``TrainerFlocking(deviceStore=True)``
  recomputes each batch's states, labels and ELL graphs there; its
  evaluation is scalars-only (``rollout_cost`` beside the expert's cost).

The deployment rolls the trained controller at --deployAgents (ELL graphs
of width --ellDegree) in every mode, reduced to its cost on the device
(``rollout_cost``): on the cell grid (``--envGrid``, the default), or with
``--no-envGrid`` on the chunked all-pairs env in row chunks of
``--envChunk`` agents (default deployAgents // 8; --largeTrain generates
on it at its own default, trainAgents // 8).

Run:  python -m graph_neural_networks_torch.examples.largeswarm
          [--device cpu] [--quick] [--largeTrain | --deviceStore]
          [--no-envGrid] [--envChunk C]
          [--trainAgents N] [--nTrain 4] [--nEpochs 5] [--batch 1]
          [--trainDuration 0.5] [--ellDegree 32] [--deployAgents 4096]

Without --quick it trains at the JAX driver's full setting (50 agents,
400 trajectories of 2 s) and deploys at 4096; the record of the JAX
package's 262,144-agent run is ``--deviceStore --trainAgents 262144
--nTrain 4 --nEpochs 5 --batch 1 --trainDuration 0.5``. Checkpoints go to
--saveDir, or to a temporary directory removed at the end.
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
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--saveDir", default=None)
    ap.add_argument("--trainAgents", type=int, default=None)
    ap.add_argument("--deployAgents", type=int, default=None)
    ap.add_argument("--ellDegree", type=int, default=32)
    ap.add_argument("--envGrid", action="store_true", default=True,
                    help="the O(N*k) cell-list grid env (the default)")
    ap.add_argument("--no-envGrid", dest="envGrid", action="store_false",
                    help="the chunked all-pairs env instead")
    ap.add_argument("--envChunk", type=int, default=None,
                    help="row chunk of the chunked env's deployment step "
                         "(default: deployAgents // 8 without the grid; 0 "
                         "disables)")
    ap.add_argument("--lamIters", type=int, default=0,
                    help="lambda passes a deployment step (0: the Rayleigh "
                         "fold of the main window pass)")
    ap.add_argument("--duration", type=float, default=None,
                    help="deployment rollout duration in seconds")
    ap.add_argument("--nTrain", type=int, default=None)
    ap.add_argument("--nEpochs", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--trainDuration", type=float, default=None,
                    help="training-trajectory duration in seconds")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--largeTrain", action="store_true",
                      help="train on Flocking.large: the expert's "
                           "supervision on the grid (or the chunked env) "
                           "with ELL graphs in the host store")
    mode.add_argument("--deviceStore", action="store_true",
                      help="train on Flocking.large_device through the "
                           "device-resident store")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    from graph_neural_networks_torch import training as T
    from graph_neural_networks_torch.data.flocking import (
        Flocking, evaluate_cost_device)
    from graph_neural_networks_torch.models.architectures_time import (
        LocalGNN_DB)
    from graph_neural_networks_torch.utils.device import resolve_device

    args = _args(argv)
    dev = resolve_device(args.device)
    if args.quick:
        n_train_agents, duration, dt = 12, 1.0, 0.1
        nTrain, nValid, nTest, nEpochs, batch = 40, 8, 8, 3, 10
        F, K = [6, 16], [3]
        n_deploy, deploy_T_s = 64, 1.0
    else:
        n_train_agents, duration, dt = 50, 2.0, 0.01
        nTrain, nValid, nTest, nEpochs, batch = 400, 20, 20, 30, 20
        F, K = [6, 64], [3]
        n_deploy, deploy_T_s = 4096, 1.0
    if args.trainAgents is not None:
        n_train_agents = args.trainAgents
    if args.deployAgents is not None:
        n_deploy = args.deployAgents
    if args.duration is not None:
        deploy_T_s = args.duration
    if args.nTrain is not None:
        nTrain = args.nTrain
        nValid = nTest = max(nTrain // 4, 1)
    if args.nEpochs is not None:
        nEpochs = args.nEpochs
    if args.batch is not None:
        batch = args.batch
    if args.trainDuration is not None:
        duration = args.trainDuration
    if args.deviceStore and not args.envGrid:
        raise SystemExit("--deviceStore requires the grid env")
    env_grid = True if args.envGrid else None
    env_chunk = args.envChunk
    if env_chunk is None and not args.envGrid:
        env_chunk = max(n_deploy // 8, 1)
    if env_chunk == 0:
        env_chunk = None

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    mode = ("Flocking.large_device" if args.deviceStore
            else "Flocking.large" if args.largeTrain else "Flocking")
    print(f"== train: {n_train_agents} agents ({mode}, {dev}) ==",
          flush=True)
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    if args.deviceStore:
        data = Flocking.large_device(
            n_train_agents, commRadius=2.0, repelDist=1.0, nTrain=nTrain,
            nValid=nValid, nTest=nTest, duration=duration, samplingTime=dt,
            ell_degree=args.ellDegree, rng=rng, env_grid=True, device=dev)
    elif args.largeTrain:
        data = Flocking.large(
            n_train_agents, commRadius=2.0, repelDist=1.0, nTrain=nTrain,
            nValid=nValid, nTest=nTest, duration=duration, samplingTime=dt,
            ell_degree=args.ellDegree, rng=rng, env_grid=env_grid,
            device=dev)
    else:
        data = Flocking(n_train_agents, commRadius=2.0, repelDist=1.0,
                        nTrain=nTrain, nValid=nValid, nTest=nTest,
                        duration=duration, samplingTime=dt, rng=rng,
                        device=dev)
    sync()
    t_gen = time.perf_counter() - t0
    arch = LocalGNN_DB(F, K, True, "tanh", [2], 1, device=dev,
                       generator=torch.Generator().manual_seed(args.seed))
    train_kw = {}
    if args.largeTrain or args.deviceStore:
        train_kw["ellDegree"] = args.ellDegree
    if args.deviceStore:
        train_kw["deviceStore"] = True
    with tempfile.TemporaryDirectory(prefix="largeswarm_") as tmp:
        model = T.Model(arch, T.losses.mse_loss, {"name": "ADAM", "lr": 5e-4},
                        T.TrainerFlocking, T.evaluate_flocking,
                        name="LocalGNNxfer", saveDir=args.saveDir or tmp)
        t0 = time.perf_counter()
        out = model.train(data, nEpochs, batch, validationInterval=20,
                          probExpert=0.993, seed=args.seed, **train_kw)
        sync()
        t_train = time.perf_counter() - t0
        if args.deviceStore:
            # scalars-only evaluation: the closed-loop test cost (Best
            # weights, reloaded by the trainer) against the expert's
            expert = float(evaluate_cost_device(data.getData("vel", "test")))
            cf, ce = data.rollout_cost(data.getData("initPos", "test"),
                                       data.getData("initVel", "test"),
                                       duration, arch,
                                       lam_iters=args.lamIters)
        else:
            expert = data.evaluate(vel=data.getData("vel", "test"))
            res = model.evaluate(data)
            cf, ce = res["costBestFull"], res["costBestEnd"]
            model.load("Best")     # evaluate leaves the Last weights loaded
    print(f"  generation {t_gen:.1f} s, training {t_train:.1f} s "
          f"({t_train / nEpochs:.1f} s/epoch)", flush=True)
    print(f"  closed-loop test cost {cf:.4f} (end {ce:.5f}) vs expert "
          f"{expert:.4f} ({cf / max(expert, 1e-9):.3f}x)", flush=True)

    where = ("cell-list grid env" if env_grid
             else f"chunked env, envChunk={env_chunk}")
    print(f"== deploy: {n_deploy} agents (ellDegree={args.ellDegree}, "
          f"{where}) ==", flush=True)
    env = Flocking.for_rollout(n_deploy, commRadius=2.0, repelDist=1.0,
                               samplingTime=dt, device=dev,
                               rng=np.random.default_rng(args.seed + 1))
    ip, iv = env.compute_initial_positions(
        n_deploy, 2, env.commRadius, minDist=env.initMinDist,
        geometry="circular", xMaxInitVel=3.0, yMaxInitVel=3.0)
    env.rollout_ell_degree = args.ellDegree
    env.rollout_lam_method = "power"
    env.rollout_env_grid = env_grid
    env.rollout_env_chunk = env_chunk
    t0 = time.perf_counter()
    # scalars-only: nothing O(T*N) leaves the device
    cf_d, ce_d = env.rollout_cost(ip, iv, deploy_T_s, arch,
                                  lam_iters=args.lamIters)
    t_roll = time.perf_counter() - t0
    steps = len(np.arange(0, deploy_T_s, dt))
    print(f"  {steps}-step closed loop: {t_roll:.2f} s, velocity-variance "
          f"cost {cf_d:.4f} (end {ce_d:.5f})", flush=True)
    result = dict(device=str(dev), mode=mode, env_grid=env_grid is not None,
                  env_chunk=env_chunk, train_agents=n_train_agents,
                  loss_first=float(out["lossTrain"][0]),
                  loss_last=float(out["lossTrain"][-1]),
                  best_valid=float(np.min(out["costValid"])),
                  cost_small=cf, cost_small_end=ce, expert=expert,
                  deploy_agents=n_deploy, cost_big=cf_d, cost_big_end=ce_d,
                  generation_s=t_gen, train_s=t_train, deploy_s=t_roll)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
