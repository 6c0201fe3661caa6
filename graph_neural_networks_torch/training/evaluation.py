"""Evaluators: run the Best and Last checkpoints on the test set; the port
of ``evaluate``, ``evaluate_single_node`` and ``evaluate_flocking`` of the
JAX package's ``training/evaluation.py`` (reference
``alegnn/modules/evaluation.py``)."""

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


def _maybe_save(model, eval_vars, do_save):
    if not do_save:
        return
    d = os.path.join(model.saveDir, "evalVars")
    os.makedirs(d, exist_ok=True)
    # filename parity with reference evaluation.py:85
    with open(os.path.join(d, f"{model.name}evalVars.pkl"), "wb") as f:
        pickle.dump(eval_vars, f)


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
    _maybe_save(model, result, doSaveVars)
    return result


def evaluate_single_node(model, data, doSaveVars: bool = True, **kwargs):
    """The same through single_node_forward at the test split's target
    ids (data.getLabelID('test')); saves evalVars like the reference
    (evaluation.py:160-166)."""
    xTest, yTest = data.getSamples("test")
    ids = list(data.getLabelID("test"))

    def run(m):
        with torch.no_grad():
            yHat = m.archit.single_node_forward(xTest, ids)
        return float(data.evaluate(yHat.cpu().numpy(), yTest))
    out = _with_checkpoints(model, run)
    result = {"costBest": out.get("Best"), "costLast": out.get("Last")}
    _maybe_save(model, result, doSaveVars)
    return result


evaluateSingleNode = evaluate_single_node


def evaluate_flocking(model, data, nVideos: int = 0, **kwargs):
    """Closed-loop trajectory cost of the Best and Last checkpoints over
    the test initial conditions: the cost over the whole trajectory and at
    the final step (costBestFull, costBestEnd, costLastFull, costLastEnd).

    The rollout is ``data.compute_trajectory`` on the dataset's
    environment (its defaults: the dataset's grid or chunked env and
    ell_degree, lam_iters 8, or the all-pairs env of a reference-scale
    dataset) with history_window the architecture's causal window, as the
    JAX evaluator passes it: an architecture with the step interface rolls
    through it, which the JAX evaluator's windowed re-forward equals up to
    float association. nVideos > 0 saves the first nVideos trajectories of
    each checkpoint with ``data.saveVideo`` under
    ``saveDir/videos{Best,Last}`` (nothing without matplotlib).
    """
    init_pos = data.getData("initPos", "test")
    init_vel = data.getData("initVel", "test")

    def run(m):
        pos, vel, _, _, _ = data.compute_trajectory(
            init_pos, init_vel, data.duration, m.archit,
            history_window=getattr(m.archit, "causal_window", None),
            return_graphs="auto")   # the cost never reads the graphs
        return {"full": float(data.evaluate(vel=vel)),
                "end": float(data.evaluate(vel=vel[:, -1:])),
                "pos": pos if nVideos > 0 else None}

    out = _with_checkpoints(model, run)
    result = {}
    for label in ("Best", "Last"):
        if label in out:
            result[f"cost{label}Full"] = out[label]["full"]
            result[f"cost{label}End"] = out[label]["end"]
            if nVideos > 0:
                data.saveVideo(f"{model.saveDir}/videos{label}",
                               out[label]["pos"][:nVideos])
    return result


evaluateFlocking = evaluate_flocking
