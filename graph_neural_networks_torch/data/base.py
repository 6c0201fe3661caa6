"""Dataset base classes: the port's copy of ``Data`` and
``DataForClassification`` of the JAX package's ``data/base.py``.

Mirrors the reference's ``_data`` / ``_dataForClassification`` contracts
(dataTools.py:141-341): samples dict with train/valid/test splits,
getSamples with count/index selection, expandDims, astype, and the
classification error-rate evaluate, and the host helpers
``normalize_data``, ``change_data_type`` and ``invert_tensor_ew``. Samples stay numpy on the host; the
Trainer moves each batch to the device.
"""

from __future__ import annotations

import numpy as np

ZERO_TOL = 1e-9


def normalize_data(x: np.ndarray, ax: int) -> np.ndarray:
    """Standardize (zero mean, unit variance) along axis `ax`
    (reference dataTools.py:52-77)."""
    x = np.asarray(x, dtype=np.float64)
    mean = x.mean(axis=ax, keepdims=True)
    std = x.std(axis=ax, keepdims=True)
    std[std < ZERO_TOL] = 1.0
    return (x - mean) / std


def change_data_type(x, dtype):
    """A numpy array of `dtype` (None stays None). The reference's
    dataTools.py:79-117 also bridged torch tensors; here samples stay numpy
    on the host and the trainers move each batch to the device."""
    if x is None:
        return None
    return np.asarray(x).astype(dtype)


def invert_tensor_ew(x: np.ndarray) -> np.ndarray:
    """Elementwise inverse that maps (near-)zeros to zero
    (reference dataTools.py:119-139)."""
    out = np.zeros_like(x, dtype=np.float64)
    mask = np.abs(x) > ZERO_TOL
    out[mask] = 1.0 / x[mask]
    return out


class Data:
    """Base dataset: train/valid/test splits of (signals, targets)."""

    def __init__(self):
        self.dataType = np.float64
        self.nTrain = None
        self.nValid = None
        self.nTest = None
        self.samples = {
            "train": {"signals": None, "targets": None},
            "valid": {"signals": None, "targets": None},
            "test": {"signals": None, "targets": None},
        }

    def getSamples(self, samplesType: str, *args):
        """All samples, a random subset (int arg), or specific indices
        (list/array arg). Reference dataTools.py:164-227."""
        assert samplesType in ("train", "valid", "test")
        x = self.samples[samplesType]["signals"]
        y = self.samples[samplesType]["targets"]
        if len(args) == 1:
            if isinstance(args[0], int):
                n_total = x.shape[0]
                idx = np.random.permutation(n_total)[:args[0]]
            else:
                idx = np.asarray(args[0])
            x = x[idx]
            y = y[idx]
        return x, y

    def expandDims(self):
        """Insert the feature dimension: B x N -> B x 1 x N (and
        B x T x N -> B x T x 1 x N). Reference dataTools.py:229-245."""
        for t in ("train", "valid", "test"):
            x = self.samples[t]["signals"]
            if x is None:
                continue
            if x.ndim == 2:
                self.samples[t]["signals"] = x[:, None, :]
            elif x.ndim == 3:
                self.samples[t]["signals"] = x[:, :, None, :]

    def astype(self, dataType):
        """Change dtype of all splits; integer targets are preserved
        (reference dataTools.py:247-271)."""
        for t in ("train", "valid", "test"):
            for k in ("signals", "targets"):
                v = self.samples[t][k]
                if v is None:
                    continue
                if k == "targets" and np.issubdtype(np.asarray(v).dtype,
                                                    np.integer):
                    continue
                self.samples[t][k] = np.asarray(v).astype(dataType)
        self.dataType = dataType


class DataForClassification(Data):
    """Adds argmax error-rate evaluation (reference dataTools.py:310-341)."""

    def evaluate(self, yHat, y, tol: float = 1e-9) -> float:
        yHat = np.asarray(yHat)
        y = np.asarray(y)
        yHat = np.argmax(yHat, axis=1)
        errors = np.abs(yHat - y) > tol
        return float(np.mean(errors))
