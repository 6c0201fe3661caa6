"""Carry trained weights from the JAX package into a ported architecture."""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def _flatten(tree, prefix=()):
    items = (enumerate(tree) if isinstance(tree, (list, tuple))
             else tree.items())
    for k, v in items:
        if isinstance(v, (Mapping, list, tuple)):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def load_flax_params(arch, params) -> None:
    """Copy a JAX parameter tree into `arch`'s parameters, in place.

    params: the tree ``arch.init`` returns on the JAX side, as nested
    dicts of numpy arrays, e.g. ``{'params': {'GraphFilter_0': {'weight',
    'bias'}, 'MLP_0': {'TorchDense_0': {'kernel', 'bias'}}}}``; the
    attention family's layers are ``GraphAttentional_<l>`` (mixer,
    weight), ``GraphFilterAttentional_<l>`` (mixer, weight, filterWeight,
    bias) and ``EdgeVariantAttentional_<l>`` (mixer, weight, bias); a
    LocalGNN_DB's are ``GraphFilterDB_<l>`` (weight, bias) and
    ``Readout/TorchDense_<i>``; a GRNN's ``hiddenState``, ``outputState``
    and ``Readout`` (GraphRecurrentNN_DB's: ``hiddenState/{aWeights,
    bWeights, xBias, zBias}``, ``outputState/{weight, bias}``); an
    aggregation GNN's ``Conv_<l>`` (kernel, bias; AggregationGNN_DB's
    readout ``Readout``). A tree without a top-level 'params' (a
    MultiNodeAggregationGNN's ``{'inner': [[...]], 'mlp': ...}``) is
    taken whole, its lists keyed by position. Each model maps the leaves
    to its own parameters (``arch.flax_names()``: path -> (parameter,
    transpose), transpose False, True for a 2-D transpose, or an axis
    permutation such as a flax Conv kernel's (2, 1, 0)). Raises KeyError
    if a leaf on either side is left unmatched, ValueError on a shape
    mismatch.

    The weights arrive in f32 (a JAX tree of bf16 leaves too). bf16
    serving needs no transplant of its own: ``serving.InferenceEngine(...,
    dtype=torch.bfloat16)`` casts a copy of the model after the transplant,
    as the JAX engine casts its params (``serving._cast_floats``).
    """
    names = arch.flax_names()
    tree = params["params"] if "params" in params else params
    leaves = dict(_flatten(tree))
    extra = sorted(set(leaves) - set(names))
    missing = sorted(set(names) - set(leaves))
    if extra or missing:
        raise KeyError(f"unmatched parameters: flax-only {extra}, "
                       f"torch-only {missing}")
    with torch.no_grad():
        for path, (p, transpose) in names.items():
            v = np.asarray(leaves[path], dtype=np.float32)
            if isinstance(transpose, tuple):
                v = np.transpose(v, transpose)
            elif transpose:
                v = v.T
            if tuple(v.shape) != tuple(p.shape):
                raise ValueError(f"{'/'.join(path)}: flax {v.shape} vs "
                                 f"torch {tuple(p.shape)}")
            p.copy_(torch.tensor(v))
