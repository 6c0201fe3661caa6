"""PyTorch port: package boundaries and device defaults."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from graph_neural_networks_torch import serving as tserving
from graph_neural_networks_torch.data import flocking as tflock
from graph_neural_networks_torch.models import architectures as tarch
from graph_neural_networks_torch.models import architectures_time as tarcht
from graph_neural_networks_torch.ops import gso as tgso


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine: one intra-op thread
    keeps the many small torch ops here from oversubscribing its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import graph_neural_networks_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in mods:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                    "graph_neural_networks_tpu"))
print(len(mods), bad)
"""


def test_package_imports_no_jax():
    """Importing every module of the port pulls in neither JAX nor the JAX
    package, and builds nothing (a subprocess: conftest imports jax)."""
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    n_mods, bad = proc.stdout.split(" ", 1)
    assert int(n_mods) >= 10 and bad.strip() == "[]", proc.stdout


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    S = np.eye(8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgso.as_gso(S, mode="band")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tarch.SelectionGNN([1, 2], [2], True, "relu", [8], "NoPool", [1],
                           [2], S)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tarch.LocalGNN([1, 2], [2], True, "relu", [8], "NoPool", [1], [2], S)
    arch = tarch.SelectionGNN([1, 2], [2], True, "relu", [8], "NoPool", [1],
                              [2], S, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserving.InferenceEngine(arch, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tflock.Flocking.for_rollout(64, 2.0, 1.0, 0.01)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tarcht.LocalGNN_DB([6, 32], [4], True, "tanh", [2], 1)
