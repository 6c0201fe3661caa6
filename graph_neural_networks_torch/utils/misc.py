"""Small host-side helpers for experiment bookkeeping and reproducibility:
the port's copy of the JAX package's ``utils/misc.py`` (reference
``alegnn/utils/miscTools.py``: num2filename, saveSeed/loadSeed,
writeVarValues) and its JSONL metrics log.

RNG state is explicit, as in the JAX package: the numpy Generator's bit
state and, in place of the JAX key, a ``torch.Generator``'s ``get_state()``
with the generator's device (a CUDA generator is restored on CUDA)."""

from __future__ import annotations

import json
import os
import pickle
from typing import Any, Mapping

import numpy as np
import torch

__all__ = ["num2filename", "save_seed", "load_seed", "write_var_values",
           "append_jsonl"]


def num2filename(x, d: str = "p") -> str:
    """Render a number as a filename-safe string, replacing the decimal
    point with `d` (reference miscTools.py:18-46). Integers lose the
    trailing '.0'."""
    if x == int(x):
        return str(int(x))
    return str(x).replace(".", d)


def save_seed(save_dir: str, *, numpy_rng: np.random.Generator | None = None,
              torch_generator: torch.Generator | None = None,
              filename: str = "randomSeedUsed.pkl") -> str:
    """Persist RNG state (the numpy Generator's bit state and/or the
    torch Generator's ``get_state()``) so an experiment can be reproduced
    (reference miscTools.py:48-66)."""
    os.makedirs(save_dir, exist_ok=True)
    state: dict[str, Any] = {}
    if numpy_rng is not None:
        state["numpy"] = numpy_rng.bit_generator.state
    if torch_generator is not None:
        state["torch_state"] = torch_generator.get_state().cpu().numpy()
        state["torch_device"] = str(torch_generator.device)
    path = os.path.join(save_dir, filename)
    with open(path, "wb") as f:
        pickle.dump(state, f)
    return path


def load_seed(load_dir: str, filename: str = "randomSeedUsed.pkl"):
    """Restore RNG state saved by :func:`save_seed`. Returns
    ``(numpy_rng | None, torch_generator | None)`` (reference
    miscTools.py:68-95). Divergence from the JAX package, whose second
    element is a ``jax.random`` key: here it is a ``torch.Generator`` on
    the saved generator's device, set to the saved state."""
    with open(os.path.join(load_dir, filename), "rb") as f:
        state = pickle.load(f)
    numpy_rng = None
    if "numpy" in state:
        numpy_rng = np.random.default_rng()
        numpy_rng.bit_generator.state = state["numpy"]
    generator = None
    if "torch_state" in state:
        generator = torch.Generator(device=state.get("torch_device", "cpu"))
        generator.set_state(torch.as_tensor(state["torch_state"],
                                            dtype=torch.uint8))
    return numpy_rng, generator


def write_var_values(file_to_write: str, var_values: Mapping[str, Any]) -> None:
    """Append `name = value` lines to a hyperparameter log file
    (reference miscTools.py:98-111)."""
    d = os.path.dirname(file_to_write)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(file_to_write, "a") as f:
        for key, value in var_values.items():
            f.write(f"{key} = {value}\n")
        f.write("\n")


def append_jsonl(path: str, record: Mapping[str, Any]) -> None:
    """Append one JSON record per line (the structured metrics log)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(record, default=float) + "\n")
