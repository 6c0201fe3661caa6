"""Evaluators: run the Best and Last checkpoints on the test set; the port
of ``evaluate`` of the JAX package's ``training/evaluation.py`` (reference
``alegnn/modules/evaluation.py:18-89``). ``evaluate_single_node`` and
``evaluate_flocking`` come with their trainers."""

from __future__ import annotations

import os
import pickle

import torch


def _with_checkpoints(model, fn):
    out = {}
    for label in ("Best", "Last"):
        try:
            model.load(label)
        except FileNotFoundError:
            continue
        out[label] = fn(model)
    return out


def evaluate(model, data, doSaveVars: bool = True, **kwargs):
    """costBest/costLast: data.evaluate on archit(xTest), under
    torch.no_grad().

    doSaveVars defaults True like the reference (evaluation.py:36-39):
    results pickled to saveDir/evalVars/{name}evalVars.pkl."""
    xTest, yTest = data.getSamples("test")

    def run(m):
        with torch.no_grad():
            yHat = m.archit.apply(xTest)
        return float(data.evaluate(yHat.cpu().numpy(), yTest))
    out = _with_checkpoints(model, run)
    result = {"costBest": out.get("Best"), "costLast": out.get("Last")}
    if doSaveVars:
        d = os.path.join(model.saveDir, "evalVars")
        os.makedirs(d, exist_ok=True)
        # filename parity with reference evaluation.py:85
        with open(os.path.join(d, f"{model.name}evalVars.pkl"), "wb") as f:
            pickle.dump(result, f)
    return result
