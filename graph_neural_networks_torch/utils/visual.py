"""Observability: scalar and figure logging and profiling helpers; the
port's copy of the JAX package's ``utils/visual.py``.

Replaces the reference's tensorboardX ``Visualizer`` (visualTools.py:11-65)
with a dependency-light logger: scalars go to JSONL (one record a call,
the same records as the JAX package's) and figures to PNG;
``export_json`` mirrors the reference's JSON export. The profiling helpers
wrap ``torch.profiler`` and ``torch.autograd``'s anomaly detection, and
add a throughput counter (edges/s) for the graph shifts. matplotlib is
never imported here: ``figure_summary`` takes a figure the caller made.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from graph_neural_networks_torch.utils.misc import append_jsonl

__all__ = ["Visualizer", "enable_nan_debugging", "profile_trace", "timed",
           "edges_per_second"]


class Visualizer:
    """Scalar/figure summary writer. name/save_dir mirror the reference
    ctor; scalars are appended to ``<save_dir>/<name>.jsonl``."""

    def __init__(self, save_dir: str, name: str = "run"):
        self.save_dir = save_dir
        self.name = name
        os.makedirs(save_dir, exist_ok=True)
        self.path = os.path.join(save_dir, f"{name}.jsonl")
        self._store: dict = {}

    def scalar_summary(self, mode: str, epoch: int, **values) -> None:
        rec = {"mode": mode, "epoch": int(epoch)}
        rec.update({k: float(v) for k, v in values.items()})
        append_jsonl(self.path, rec)
        self._store.setdefault(mode, []).append(rec)

    def figure_summary(self, tag: str, figure) -> str:
        """Save a matplotlib figure as ``<save_dir>/<name>_<tag>.png``."""
        out = os.path.join(self.save_dir, f"{self.name}_{tag}.png")
        figure.savefig(out)
        return out

    def histogram_summary(self, tag: str, values, epoch: int = 0) -> None:
        if isinstance(values, torch.Tensor):
            values = values.detach().cpu().numpy()
        v = np.asarray(values).ravel()
        self.scalar_summary(f"hist/{tag}", epoch, mean=v.mean(),
                            std=v.std(), min=v.min(), max=v.max())

    def text_summary(self, tag: str, text: str) -> None:
        append_jsonl(self.path, {"mode": f"text/{tag}", "text": text})

    def export_json(self, path: Optional[str] = None) -> str:
        path = path or os.path.join(self.save_dir, f"{self.name}.json")
        with open(path, "w") as f:
            json.dump(self._store, f, default=float)
        return path


def enable_nan_debugging(enable: bool = True) -> None:
    """Turn torch.autograd's anomaly detection on or off: a backward that
    produces NaN raises at the producing op, with the forward's traceback
    (the port's counterpart of the JAX package's jax_debug_nans)."""
    torch.autograd.set_detect_anomaly(enable)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """torch.profiler over the block (CPU, and CUDA where there is a
    device); on exit the trace is written as Chrome trace JSON to
    ``<log_dir>/trace.json`` (open it in Perfetto or chrome://tracing).
    Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def timed(fn: Callable, *args, iters: int = 10, warmup: int = 2,
          **kwargs) -> float:
    """Mean wall seconds of one call of `fn`, after `warmup` calls; CUDA
    (where there is a device) is synchronized before the clock starts and
    after the last call."""
    for _ in range(warmup):
        fn(*args, **kwargs)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args, **kwargs)
    _sync()
    return (time.perf_counter() - t0) / iters


def edges_per_second(n_edges: int, n_rows: int, n_shifts: int,
                     seconds: float) -> float:
    """Throughput counter for K-tap graph convolutions."""
    return n_rows * n_shifts * n_edges / seconds
