"""Epidemic tracking with Graph RNNs (reference examples/epidemicGRNN.py),
trained with the port.

Predicts the future infection status (8 steps ahead) of each student on
the SocioPatterns high-school friendship graph from the first 8 steps of
an SIR process. Compares a plain Graph RNN against its time-, node- and
edge-gated variants, trained on the differentiable 1-F1 loss
(epidemicGRNN.py:116-158, 205-287: F=1 -> H=12 -> 2, K=[5,5], tanh/ReLU,
lr 5e-4, 10 epochs, batch 100, nTrain 1000, seqLen 8). Without --dataDir
(or without its edge_list.txt) the graph is Epidemics' SBM fallback.

Run:  python -m graph_neural_networks_torch.examples.epidemic
          [--quick] [--device cpu] [--dataDir PATH] [--epochs N]
"""

from __future__ import annotations

import numpy as np

from graph_neural_networks_torch.examples import _task


def _args(argv):
    ap = _task.parser(__doc__, "experiments/epidemic")
    ap.add_argument("--dataDir", default=None,
                    help="directory containing edge_list.txt (or "
                         "epidemics/edge_list.txt)")
    return ap.parse_args(argv)


def setup(args) -> _task.Task:
    from graph_neural_networks_torch import data as D
    from graph_neural_networks_torch import training as T
    from graph_neural_networks_torch.models import architectures as archs

    rng = np.random.default_rng(args.seed)
    if args.quick:
        seqLen, nTrain, nValid, nTest, nEpochs, batch = 4, 300, 50, 50, 20, 50
        H, K = 8, [3, 3]
    else:
        seqLen, nTrain, nValid, nTest, nEpochs, batch = 8, 1000, 120, 200, 10, 100
        H, K = 12, [5, 5]
    data = D.Epidemics(seqLen, 0.05, 0.3, 4, nTrain, nValid, nTest,
                       data_dir=args.dataDir, rng=rng)
    data.expandDims()
    W = data.Adj.astype(np.float64)
    S = W / _task.max_eig(W)
    print(f"== Epidemics: N={data.N}, seqLen={seqLen}, "
          f"{nTrain}/{nValid}/{nTest} samples ==", flush=True)

    gen = _task.seeded(args.seed)

    def build(gate):
        if gate is None:
            return lambda dev: archs.GraphRecurrentNN(
                1, 2, H, K, True, "tanh", "relu", "relu", [2], S,
                device=dev, generator=gen())
        return lambda dev: archs.GatedGraphRecurrentNN(
            1, 2, H, K, True, "tanh", "relu", "relu", [2], S, gateType=gate,
            device=dev, generator=gen())
    variants = [("GRNN", None)] + [
        (f"GatedGRNN-{g}", g)
        for g in (("time",) if args.quick else ("time", "node", "edge"))]
    models = [_task.ModelSpec(name, build(gate), T.losses.f1_score_loss,
                              T.Trainer, T.evaluate, 5e-4, 3)
              for name, gate in variants]
    return _task.Task(data, models, args.epochs or nEpochs, batch)


def main(argv=None) -> dict:
    from graph_neural_networks_torch.utils.device import resolve_device
    args = _args(argv)
    dev = resolve_device(args.device)
    task = setup(args)
    with _task.save_dir(args.saveDir) as out:
        return _task.run_all(task, dev, out, "1-F1")


if __name__ == "__main__":
    main()
