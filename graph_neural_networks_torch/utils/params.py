"""Carry trained weights from the JAX package into a ported architecture."""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _flax_names(core):
    """flax leaf path -> (torch parameter, transpose?) for a _ConvCore.

    The JAX core names its submodules in creation order: <LayerClass>_<l>
    for filter layer l (GraphFilter_0, GraphAttentional_1, ...), whose
    parameters carry the torch layer's names (weight, bias, mixer,
    filterWeight), and MLP_0 holding TorchDense_<i>. A flax dense kernel
    is (fan_in, out); the torch weight is (out, fan_in).
    """
    names = {}
    for l, f in enumerate(core.filters):
        for name, p in f.named_parameters():
            names[(f"{type(f).__name__}_{l}", name)] = (p, False)
    for i, layer in enumerate(core.readout.layers):
        names[("MLP_0", "TorchDense_%d" % i, "kernel")] = (layer.weight, True)
        if layer.bias is not None:
            names[("MLP_0", "TorchDense_%d" % i, "bias")] = (layer.bias, False)
    return names


def load_flax_params(arch, params) -> None:
    """Copy a JAX parameter tree into `arch`'s parameters, in place.

    params: the tree ``arch.init`` returns on the JAX side, as nested
    dicts of numpy arrays, e.g. ``{'params': {'GraphFilter_0': {'weight',
    'bias'}, 'MLP_0': {'TorchDense_0': {'kernel', 'bias'}}}}``; the
    attention family's layers are ``GraphAttentional_<l>`` (mixer,
    weight), ``GraphFilterAttentional_<l>`` (mixer, weight, filterWeight,
    bias) and ``EdgeVariantAttentional_<l>`` (mixer, weight, bias). Raises
    KeyError if a leaf on either side is left unmatched, ValueError on a
    shape mismatch.
    """
    names = _flax_names(arch.core)
    leaves = dict(_flatten(params["params"]))
    extra = sorted(set(leaves) - set(names))
    missing = sorted(set(names) - set(leaves))
    if extra or missing:
        raise KeyError(f"unmatched parameters: flax-only {extra}, "
                       f"torch-only {missing}")
    with torch.no_grad():
        for path, (p, transpose) in names.items():
            v = np.asarray(leaves[path], dtype=np.float32)
            if transpose:
                v = v.T
            if tuple(v.shape) != tuple(p.shape):
                raise ValueError(f"{'/'.join(path)}: flax {v.shape} vs "
                                 f"torch {tuple(p.shape)}")
            p.copy_(torch.tensor(v))
