"""Model: binds an architecture with its loss, optimizer, trainer and
evaluator; the port of the JAX package's ``training/model.py`` (reference
``alegnn/modules/model.py``).

The architecture is built beforehand and owns its parameters (a ported
architecture wrapper with ``.core``, or any ``nn.Module``); the Model owns
the ``torch.optim`` optimizer, an optional learning-rate scheduler, and the
Best/Last checkpoint contract (reference model.py:106-129):
``saveDir/savedModels/{name}{label}.ckpt`` holds the parameters, the
optimizer (and scheduler) state and the training-loop state in ``extra``,
written with ``torch.save``.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import torch
from torch import nn


def make_optimizer(spec, params) -> torch.optim.Optimizer:
    """A torch.optim optimizer over `params` from a spec dict
    ({'name': 'ADAM'|'SGD'|'RMSprop', 'lr': float, ...}, the keys of the
    JAX package's make_optimizer) or a callable params -> optimizer.

    ADAM: beta1, beta2 (0.9, 0.999), eps 1e-8 as optax.adam. SGD:
    momentum (0), no dampening or Nesterov, as optax.sgd. RMSprop:
    smoothing 0.9 as optax.rmsprop's decay; torch adds eps (1e-8) outside
    the square root, optax inside.
    """
    params = list(params)
    if callable(spec):
        return spec(params)
    name = spec["name"].upper()
    lr = spec.get("lr", spec.get("learningRate", 1e-3))
    if name == "ADAM":
        return torch.optim.Adam(params, lr=lr, betas=(spec.get("beta1", 0.9),
                                                      spec.get("beta2", 0.999)))
    if name == "SGD":
        return torch.optim.SGD(params, lr=lr,
                               momentum=spec.get("momentum", 0.0))
    if name == "RMSPROP":
        return torch.optim.RMSprop(params, lr=lr, alpha=0.9)
    raise ValueError(f"unknown optimizer: {name}")


def _module(archit) -> nn.Module:
    """The nn.Module holding an architecture's parameters."""
    return archit.core if hasattr(archit, "core") else archit


class Model:

    def __init__(self, archit, loss: Callable, optimizer, trainer,
                 evaluator, name: str = "model",
                 saveDir: str = "experiments"):
        self.archit = archit
        self.loss = loss
        self.optimizer_spec = optimizer
        self.trainer = trainer
        self.evaluator = evaluator
        self.name = name
        self.saveDir = saveDir
        self.scheduler = None
        self.optimizer = make_optimizer(optimizer, archit.parameters())

    @property
    def nParameters(self) -> int:
        return sum(p.numel() for p in self.archit.parameters())

    def rebuild_optimizer(self, schedule: Optional[Callable] = None):
        """Recreate the optimizer with empty state; `schedule`, a callable
        optimizer -> torch.optim.lr_scheduler.LRScheduler, attaches a
        learning-rate schedule stepped once a training step."""
        self.optimizer = make_optimizer(self.optimizer_spec,
                                        self.archit.parameters())
        self.scheduler = None if schedule is None else schedule(self.optimizer)

    # -- training / evaluation --------------------------------------------
    def train(self, data, nEpochs, batchSize, **kwargs):
        trainer = self.trainer(self, data, nEpochs, batchSize, **kwargs)
        return trainer.train()

    def evaluate(self, data, **kwargs):
        return self.evaluator(self, data, **kwargs)

    # -- checkpointing (Best/Last contract) --------------------------------
    def _ckpt_path(self, label: str) -> str:
        d = os.path.join(self.saveDir, "savedModels")
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, f"{self.name}{label}.ckpt")

    def save(self, label: str = "", extra: Optional[dict] = None) -> str:
        """Checkpoint parameters + optimizer (+ scheduler) state, and the
        optional training-loop state `extra` (step counters, RNG state,
        best-score bookkeeping: the mid-run resume contract)."""
        path = self._ckpt_path(label)
        torch.save({
            "params": _module(self.archit).state_dict(),
            "opt_state": self.optimizer.state_dict(),
            "scheduler": (None if self.scheduler is None
                          else self.scheduler.state_dict()),
            "extra": extra,
        }, path)
        return path

    def load(self, label: str = "") -> Optional[dict]:
        """Restore parameters and optimizer (and scheduler) state; returns
        the saved training-loop state (or None). Raises FileNotFoundError
        when there is no such checkpoint."""
        # the checkpoint holds numpy RNG state and lists: not weights only
        blob = torch.load(self._ckpt_path(label), weights_only=False,
                          map_location=next(self.archit.parameters()).device)
        _module(self.archit).load_state_dict(blob["params"])
        self.optimizer.load_state_dict(blob["opt_state"])
        if self.scheduler is not None and blob["scheduler"] is not None:
            self.scheduler.load_state_dict(blob["scheduler"])
        return blob.get("extra")

    def __repr__(self):
        return (f"Model(name={self.name!r}, "
                f"archit={type(self.archit).__name__}, "
                f"nParameters={self.nParameters})")
