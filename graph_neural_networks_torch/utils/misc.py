"""Small host-side helpers for experiment bookkeeping: the port's copy of
``write_var_values`` and ``append_jsonl`` from the JAX package's
``utils/misc.py`` (reference ``alegnn/utils/miscTools.py``)."""

from __future__ import annotations

import json
import os
from typing import Any, Mapping

__all__ = ["write_var_values", "append_jsonl"]


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
