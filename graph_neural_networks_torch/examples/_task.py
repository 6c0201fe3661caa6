"""What the task drivers share: the arguments every driver takes, a model
spec (built on any device from one torch seed), and the loop that trains
and evaluates each model of a task through ``training.Model``.

A driver's ``setup(args)`` returns a :class:`Task` (the dataset and the
model specs, in the JAX driver's order); its ``main(argv)`` runs every
spec on ``--device`` and returns the JAX driver's result dict.
"""

from __future__ import annotations

import argparse
import contextlib
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch


def parser(doc: str, save_dir: str) -> argparse.ArgumentParser:
    """--quick, --device (default cuda), --seed, --saveDir (default: a
    temporary directory removed at the end; `save_dir` names the JAX
    driver's) and --epochs (overrides the task's nEpochs)."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true", help="tiny config")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch path)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--saveDir", default=None,
                    help=f"checkpoints (the JAX driver's: {save_dir}; "
                         "default a temporary directory)")
    ap.add_argument("--epochs", type=int, default=None,
                    help="override nEpochs")
    return ap


@dataclass
class ModelSpec:
    """One model of a task: `build(device)` makes the architecture with
    the weights of the task's torch seed, so that two builds on two
    devices hold the same weights."""
    name: str
    build: Callable
    loss: Callable
    trainer: type
    evaluator: Callable
    lr: float
    validationInterval: int
    train_kw: dict = field(default_factory=dict)


@dataclass
class Task:
    data: object
    models: list
    nEpochs: int
    batch: int
    S: object = None      # the GSO, where main() needs it after training


def seeded(seed: int) -> Callable[[], torch.Generator]:
    """A fresh CPU generator at `seed` per call (each model of a JAX
    driver initializes from PRNGKey(seed))."""
    return lambda: torch.Generator().manual_seed(seed)


@contextlib.contextmanager
def save_dir(path):
    if path:
        yield path
        return
    with tempfile.TemporaryDirectory(prefix="task_") as tmp:
        yield tmp


def make_model(spec: ModelSpec, device, out_dir: str):
    from graph_neural_networks_torch import training as T
    return T.Model(spec.build(device), spec.loss,
                   {"name": "ADAM", "lr": spec.lr}, spec.trainer,
                   spec.evaluator, name=spec.name, saveDir=out_dir)


def run(spec: ModelSpec, task: Task, device, out_dir: str):
    """Train the spec's model and evaluate it: (evaluation result, model,
    training seconds)."""
    model = make_model(spec, device, out_dir)
    print(f"{spec.name}: {model.nParameters} params; training...",
          flush=True)
    t0 = time.perf_counter()
    model.train(task.data, task.nEpochs, task.batch,
                validationInterval=spec.validationInterval, **spec.train_kw)
    seconds = time.perf_counter() - t0
    return model.evaluate(task.data), model, seconds


def run_all(task: Task, device, out_dir: str, metric: str) -> dict:
    """Every spec in order: {name: evaluation result}, each printed."""
    results = {}
    for spec in task.models:
        res, _, seconds = run(spec, task, device, out_dir)
        results[spec.name] = res
        print(f"  {metric}: best {res['costBest']:.4f} "
              f"last {res['costLast']:.4f} ({seconds:.1f} s)", flush=True)
    print("== summary ==")
    for name, res in results.items():
        print(f"{name}: test {metric} {res['costBest']:.4f}")
    return results


def max_eig(W) -> float:
    """The largest |eigenvalue| of a symmetric W (the tasks' S scale)."""
    return float(np.max(np.abs(np.linalg.eigvalsh(W))))
