"""Architectures: SelectionGNN, LocalGNN and the attention family
(GraphAttentionNetwork, GraphConvolutionAttentionNetwork,
EdgeVariantAttention) on the shared convolutional core.

The port of the JAX package's ``models/architectures.py`` for the ported
slices.
As there, each architecture is a host-side wrapper that (1) orders the
nodes, (2) precomputes the structure tables (GSO layout, input gather map,
pooling neighborhoods) once into ``ctx``, and (3) owns a core module whose
forward takes ``(x, ctx)``, so ``changeGSO`` rebuilds ctx and keeps the
parameters. Constructors keep the JAX (and reference) argument names and
add ``device`` and ``generator``: parameters are drawn on the CPU from the
generator (a fresh ``torch.Generator`` seeded 0 when none is given) and
then moved to the device.

Signals x: (B, F0, N).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import scipy.sparse
import torch
from torch import nn

from graph_neural_networks_torch.models import layers as gll
from graph_neural_networks_torch.ops import gso as gso_lib
from graph_neural_networks_torch.utils import graph as gt
from graph_neural_networks_torch.utils.device import resolve_device

__all__ = ["SelectionGNN", "LocalGNN", "GraphAttentionNetwork",
           "GraphConvolutionAttentionNetwork", "EdgeVariantAttention",
           "resolve_activation", "TorchDense", "MLP"]

ATTENTION_KINDS = ("gat", "gcat", "ev_attention")
ATTENTION_MODES = ("dense", "band")

_ACTIVATIONS = {
    "relu": torch.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "leaky_relu": nn.functional.leaky_relu,
    "abs": torch.abs,
    "identity": (lambda x: x),
    "none": (lambda x: x),
}


def resolve_activation(f) -> Callable:
    """Accept a callable or a registry name ('relu', 'tanh', ...)."""
    if callable(f):
        return f
    if isinstance(f, str) and f.lower() in _ACTIVATIONS:
        return _ACTIVATIONS[f.lower()]
    raise ValueError(f"unknown nonlinearity: {f!r}")


def _resolve_pool(rho) -> str:
    if rho is None:
        return "NoPool"
    if isinstance(rho, str) and rho in ("NoPool", "MaxPoolLocal"):
        return rho
    if rho is gll.NoPool:
        return "NoPool"
    if rho is gll.MaxPoolLocal:
        return "MaxPoolLocal"
    raise ValueError(f"unknown pooling function: {rho!r}")


class TorchDense(nn.Module):
    """Linear layer with torch.nn.Linear's layout (weight (out, in)) and
    default init U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True, *, generator: torch.Generator,
                 device):
        super().__init__()
        bound = 1.0 / math.sqrt(in_features)
        self.weight = gll.uniform_parameter((out_features, in_features),
                                            bound, generator, device)
        self.bias = (gll.uniform_parameter((out_features,), bound, generator,
                                           device) if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nn.functional.linear(x, self.weight, self.bias)


class MLP(nn.Module):
    """Dense stack with the reference's convention: nonlinearity between
    layers, never after the last. No dims: identity."""

    def __init__(self, in_features: int, dims, sigma: Callable,
                 use_bias: bool = True, *, generator: torch.Generator,
                 device):
        super().__init__()
        self.sigma = sigma
        sizes = [in_features] + list(dims)
        self.layers = nn.ModuleList(
            TorchDense(a, b, use_bias, generator=generator, device=device)
            for a, b in zip(sizes[:-1], sizes[1:]))

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            if i > 0:
                y = self.sigma(y)
            y = layer(y)
        return y

    def flax_names(self, scope: str) -> dict:
        """flax leaf path -> (torch parameter, transpose?) of the stack the
        JAX model holds as `scope`/TorchDense_<i>. A flax dense kernel is
        (fan_in, out); the torch weight is (out, fan_in)."""
        names = {}
        for i, layer in enumerate(self.layers):
            names[(scope, f"TorchDense_{i}", "kernel")] = (layer.weight, True)
            if layer.bias is not None:
                names[(scope, f"TorchDense_{i}", "bias")] = (layer.bias, False)
        return names


def _normalize_gso(GSO) -> np.ndarray:
    GSO = np.asarray(GSO, dtype=np.float64)
    if GSO.ndim == 2:
        GSO = GSO[None]
    if not (GSO.ndim == 3 and GSO.shape[1] == GSO.shape[2]):
        raise ValueError(f"GSO must be (N, N) or (E, N, N), got {GSO.shape}")
    return GSO


def _as_tuple(x):
    return tuple(int(v) for v in x)


# ---------------------------------------------------------------------------
# The shared convolutional core: (filter -> activation -> pooling) x L + readout
# ---------------------------------------------------------------------------

class _ConvCore(nn.Module):
    """Stack of graph-filter layers plus readout. Ported kinds: graph_filter
    and the attention filters (gat, gcat, ev_attention), pointwise
    activations, no_pool/max_local pooling, mlp/per_node readout; the
    others of the JAX core raise NotImplementedError.

    taps: K per layer (heads for gat); taps2: heads per layer for gcat and
    ev_attention. Attention layers grow the features by concatenating
    their heads on inner layers (g_in = F[l] * heads[l-1]), average them on
    the last, and apply the nonlinearity themselves.
    """

    def __init__(self, *, filter_kind: str, dims: tuple, taps: tuple,
                 n_nodes: tuple, sigma: Callable, taps2: tuple = (),
                 act_kind: str = "pointwise", pool_kind: str = "max_local",
                 readout_dims: tuple = (), readout_kind: str = "mlp",
                 use_bias: bool = True, edge_features: int = 1,
                 generator: torch.Generator, device):
        super().__init__()
        if filter_kind not in ("graph_filter",) + ATTENTION_KINDS:
            raise NotImplementedError(
                f"filter kind {filter_kind!r} is not ported yet")
        if act_kind != "pointwise":
            raise NotImplementedError(
                f"activation kind {act_kind!r} is not ported yet")
        if pool_kind not in ("no_pool", "max_local"):
            raise NotImplementedError(
                f"pooling kind {pool_kind!r} is not ported yet")
        if readout_kind not in ("mlp", "per_node"):
            raise NotImplementedError(
                f"readout kind {readout_kind!r} is not ported yet")
        self.filter_kind = filter_kind
        self.dims, self.taps, self.taps2 = dims, taps, taps2
        self.n_nodes = n_nodes
        self.sigma = sigma
        self.pool_kind, self.readout_kind = pool_kind, readout_kind
        self.filters = nn.ModuleList(
            self._make_filter(l, use_bias, edge_features, generator, device)
            for l in range(len(taps)))
        readout_in = (dims[-1] * n_nodes[-1] if readout_kind == "mlp"
                      else dims[-1])
        self.readout = MLP(readout_in, readout_dims, sigma, use_bias,
                           generator=generator, device=device)

    def _make_filter(self, l, use_bias, E, generator, device) -> nn.Module:
        F, K, kind = self.dims, self.taps, self.filter_kind
        made = dict(generator=generator, device=device)
        if kind == "graph_filter":
            return gll.GraphFilter(F[l], F[l + 1], K[l], E, use_bias, **made)
        heads = K if kind == "gat" else self.taps2
        g_in = F[l] if l == 0 else F[l] * heads[l - 1]
        concat = l < len(K) - 1
        if kind == "gat":
            return gll.GraphAttentional(g_in, F[l + 1], heads[l], E,
                                        self.sigma, concat, **made)
        layer = (gll.GraphFilterAttentional if kind == "gcat"
                 else gll.EdgeVariantAttentional)
        return layer(g_in, F[l + 1], K[l], heads[l], E, use_bias, self.sigma,
                     concat, **made)

    def _pool(self, l: int, x, ctx):
        if self.pool_kind == "no_pool":
            return x
        n_in, n_out = self.n_nodes[l], self.n_nodes[l + 1]
        if n_in == n_out and ctx["pool_nbh"][l] is None:
            return x
        return gll.MaxPoolLocal(n_in, n_out, 0)(x, ctx["pool_nbh"][l])

    def forward(self, x: torch.Tensor, ctx: dict):
        # node reordering by gather map: map[j] = source node of slot j, or
        # -1 for a fake (zero) node
        idx = ctx["order_map"]
        x = torch.where(idx >= 0, x[:, :, idx.clamp(min=0)], 0.0)
        for l, graph_filter in enumerate(self.filters):
            x = graph_filter(x, ctx["S"])
            if self.filter_kind == "graph_filter":
                x = self.sigma(x)   # attention layers apply it inside
            x = self._pool(l, x, ctx)
        y_gfl = x
        if self.readout_kind == "mlp":
            y = self.readout(x.reshape(x.shape[0], self.dims[-1] * x.shape[-1]))
        else:
            y = self.readout(x.transpose(1, 2)).transpose(1, 2)
        return y, y_gfl

    def flax_names(self) -> dict:
        """flax leaf path -> (torch parameter, transpose?). The JAX core
        names its submodules in creation order: <LayerClass>_<l> for filter
        layer l (GraphFilter_0, GraphAttentional_1, ...), whose parameters
        carry the torch layer's names (weight, bias, mixer, filterWeight),
        and MLP_0 for the readout."""
        names = {(f"{type(f).__name__}_{l}", name): (p, False)
                 for l, f in enumerate(self.filters)
                 for name, p in f.named_parameters()}
        names.update(self.readout.flax_names("MLP_0"))
        return names


# ---------------------------------------------------------------------------
# Wrapper base
# ---------------------------------------------------------------------------

class _ArchBase:
    """Host-side architecture wrapper: owns the core module, the ctx dict
    of device tensors and the node order."""

    core: _ConvCore
    ctx: dict
    order: list
    device: torch.device

    def parameters(self):
        return self.core.parameters()

    def flax_names(self) -> dict:
        return self.core.flax_names()

    def to(self, device) -> "_ArchBase":
        """Move parameters and ctx to `device` (in place, like nn.Module).
        A sharded model (:meth:`shard`) stays on its mesh: it takes only the
        mesh's home device and raises on any other."""
        dev = resolve_device(device)
        self.ctx = {k: _ctx_to(v, dev) for k, v in self.ctx.items()}
        self.core.to(dev)
        self.S = self.ctx["S"]
        self.device = dev
        return self

    # -- forward contracts -------------------------------------------------
    def split_forward(self, x):
        """(readout output, last graph-filter-layer output)."""
        x = torch.as_tensor(x, device=self.device)
        if x.dtype != torch.float32:
            x = x.to(torch.float32)   # f64/int inputs: compute in f32
        return self.core(x, self.ctx)

    def apply(self, x):
        return self.split_forward(x)[0]

    def __call__(self, x):
        return self.apply(x)

    def single_node_forward(self, x, nodes):
        """Output at specific (original-id) nodes, one per batch element."""
        y = self.apply(x)                              # B x dim x N
        B = y.shape[0]
        if isinstance(nodes, int):
            nodes = [nodes] * B
        order = list(self.order)
        perm_nodes = torch.as_tensor([order.index(int(n)) for n in nodes],
                                     device=y.device)
        return y[torch.arange(B, device=y.device), :, perm_nodes]


def _ctx_to(v, dev):
    # tensors, a Gso and a parallel.ShardedGso (duck-typed on `to`)
    if hasattr(v, "to"):
        return v.to(dev)
    if isinstance(v, tuple):
        return tuple(_ctx_to(t, dev) for t in v)
    return v


def _pool_tables(S_np, N_list, alpha, L, device):
    """Per-layer MaxPoolLocal neighborhood tables (or None when the layer
    keeps all nodes — identity pooling)."""
    tables = []
    for l in range(L):
        if N_list[l + 1] == N_list[l] and alpha[l] <= 1:
            tables.append(None)
            continue
        tbl = gt.compute_neighborhood(S_np, alpha[l], n_rows=N_list[l + 1],
                                      nb=N_list[l], output_type="matrix")
        tables.append(torch.as_tensor(tbl, dtype=torch.long, device=device))
    return tuple(tables)


class _SelectionBase(_ArchBase):
    """Shared build of the Selection-GNN-shaped architectures: ordering,
    GSO layout, pooling tables, core. The attention family builds its GSO
    in ``attentionMode`` ('dense', or 'band' for the flash kernels)."""

    readout_kind = "mlp"
    filter_kind = "graph_filter"

    def __init__(self, dims, taps, bias, nonlinearity, nSelectedNodes,
                 poolingFunction, poolingSize, readout_dims, GSO, order,
                 gsoMode, device, generator, taps2=(),
                 attentionMode="dense"):
        GSO = _normalize_gso(GSO)
        if len(dims) != len(taps) + 1:
            raise ValueError(f"{len(dims)} signal dims for {len(taps)} layers")
        if attentionMode == "edge":
            raise NotImplementedError(
                "attentionMode='edge' (the edge-list attention of "
                "ops/attention_sparse.py) is not ported yet (ROADMAP queue 1 "
                "item 8)")
        if attentionMode not in ATTENTION_MODES:
            raise ValueError(f"unknown attentionMode {attentionMode!r}; one "
                             f"of {ATTENTION_MODES} ('edge' not ported)")
        self.device = resolve_device(device)
        self._cfg = dict(bias=bias, sigma=resolve_activation(nonlinearity),
                         dims=_as_tuple(dims), taps=_as_tuple(taps),
                         taps2=_as_tuple(taps2),
                         readout=_as_tuple(readout_dims),
                         pool=_resolve_pool(poolingFunction))
        self.E = GSO.shape[0]
        self.order_name = order
        self.gso_mode = (attentionMode if self.filter_kind in ATTENTION_KINDS
                         else gsoMode)
        self.core = None
        self._generator = (torch.Generator().manual_seed(0)
                           if generator is None else generator)
        self._build(GSO, nSelectedNodes, poolingSize)

    def _build(self, GSO, nSelectedNodes, poolingSize):
        cfg = self._cfg
        L = len(cfg["taps"])
        S_np, order = gt.permutation_by_name(self.order_name)(GSO)
        self.order = order
        # the ordered GSO that shard() partitions, kept sparse
        self._S_sparse = [scipy.sparse.csr_matrix(m) for m in
                          (S_np if S_np.ndim == 3 else S_np[None])]
        N = S_np.shape[1]
        N_list = [N] + list(nSelectedNodes)
        alpha = list(poolingSize)
        self.alpha = alpha
        pool_kind = "no_pool" if cfg["pool"] == "NoPool" else "max_local"
        self.ctx = {
            "S": gso_lib.as_gso(S_np, mode=self.gso_mode, device=self.device),
            "order_map": torch.as_tensor(np.asarray(order), dtype=torch.long,
                                         device=self.device),
            "pool_nbh": (_pool_tables(S_np, N_list, alpha, L, self.device)
                         if pool_kind == "max_local" else (None,) * L),
        }
        if self.core is None:
            self.core = _ConvCore(
                filter_kind=self.filter_kind, dims=cfg["dims"],
                taps=cfg["taps"], taps2=cfg["taps2"],
                n_nodes=tuple(N_list), sigma=cfg["sigma"],
                pool_kind=pool_kind, readout_dims=cfg["readout"],
                readout_kind=self.readout_kind, use_bias=cfg["bias"],
                edge_features=self.E, generator=self._generator,
                device=self.device)
        else:
            self.core.n_nodes = tuple(N_list)
        self.S = self.ctx["S"]
        self.N = N_list

    def changeGSO(self, GSO, nSelectedNodes=None, poolingSize=None):
        """Re-derive ordering and structure for a new GSO, keeping the
        parameters."""
        GSO = _normalize_gso(GSO)
        if not nSelectedNodes:
            nSelectedNodes = self.N[1:]
        if not poolingSize:
            poolingSize = self.alpha
        self._build(GSO, nSelectedNodes, poolingSize)

    change_gso = changeGSO

    def shard(self, mesh, n_parts: int, order: str = "none",
              data_axis: Optional[str] = None) -> "_SelectionBase":
        """Run this architecture's graph shifts and attention node-sharded
        over `mesh`'s 'graph' axis: ctx['S'] becomes a parallel.ShardedGso
        backed by a sparse band-slab partition of the ordered GSO (never a
        dense N x N on the device), and the model moves to the mesh's home
        device, where its inputs and outputs live. In place; returns self.

        order: 'none' keeps this architecture's own node ordering (exact
        parity with the unsharded forward; a halo ring only if that
        ordering is already banded). 'rcm' composes a locality-preserving
        reorder into the model's input gather map, allowed only with
        identity pooling: selection pooling is position-semantic in the
        reference (graphML.py:2003-2019), so reordering would change it.
        data_axis: also shard the batch over this mesh axis (hybrid data x
        graph parallelism).
        """
        if order != "none" and self.core.pool_kind != "no_pool" and any(
                t is not None for t in self.ctx["pool_nbh"]):
            raise ValueError("order='rcm' requires identity pooling "
                             "(position-semantic selection pooling forbids "
                             "reordering)")
        from graph_neural_networks_torch.parallel import (ShardedGso,
                                                          partition_nodes)
        part = partition_nodes(self._S_sparse, n_parts, order=order)
        self.to(mesh.home)
        if order != "none":
            # compose the partition order into the input gather map and
            # extend it with fake (-1 -> zero) nodes for the padding
            old_map = self.ctx["order_map"].cpu().numpy()
            new_map = old_map[part.order]
            pad = part.n_padded - len(new_map)
            if pad:
                new_map = np.concatenate(
                    [new_map, np.full(pad, -1, new_map.dtype)])
            self.ctx = dict(self.ctx, order_map=torch.as_tensor(
                new_map, dtype=torch.long, device=self.device))
            self.order = [self.order[i] for i in part.order]
        self.ctx["S"] = self.S = ShardedGso(mesh, part, data_axis=data_axis)
        return self


# ---------------------------------------------------------------------------
# Concrete architectures
# ---------------------------------------------------------------------------

class SelectionGNN(_SelectionBase):
    """Selection GNN: (GraphFilter -> sigma -> pooling) x L + global MLP.

    gsoMode: 'dense' (torch.einsum shifts), 'band' or 'bcsr' (the CUDA
    SpMM kernels on a CUDA device). coarsening=True is not ported yet.
    """

    def __init__(self, dimNodeSignals, nFilterTaps, bias, nonlinearity,
                 nSelectedNodes, poolingFunction, poolingSize, dimLayersMLP,
                 GSO, order=None, coarsening=False, gsoMode="dense", *,
                 device="cuda", generator: Optional[torch.Generator] = None):
        if coarsening and _normalize_gso(GSO).shape[0] == 1:
            # (the JAX SelectionGNN coarsens only single-edge-feature GSOs)
            raise NotImplementedError(
                "SelectionGNN(coarsening=True) is not ported yet")
        super().__init__(dimNodeSignals, nFilterTaps, bias, nonlinearity,
                         nSelectedNodes, poolingFunction, poolingSize,
                         dimLayersMLP, GSO, order, gsoMode, device, generator)


class LocalGNN(_SelectionBase):
    """Selection GNN with a per-node linear readout (+ single_node_forward).
    Like the JAX LocalGNN it takes no gsoMode: its shifts are dense."""

    readout_kind = "per_node"

    def __init__(self, dimNodeSignals, nFilterTaps, bias, nonlinearity,
                 nSelectedNodes, poolingFunction, poolingSize, dimReadout,
                 GSO, order=None, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__(dimNodeSignals, nFilterTaps, bias, nonlinearity,
                         nSelectedNodes, poolingFunction, poolingSize,
                         dimReadout, GSO, order, "dense", device, generator)


class GraphAttentionNetwork(_SelectionBase):
    """GAT stack: heads concatenated on inner layers, averaged on the last.
    Reference: architectures.py:3575-3814.

    attentionMode: 'dense' (torch.einsum over the (B,P,E,N,N)
    coefficients) or 'band' (the flash attention kernels on a CUDA
    device; their plain versions on the CPU); 'edge' is not ported yet.
    """

    filter_kind = "gat"

    def __init__(self, dimNodeSignals, nAttentionHeads, nonlinearity,
                 nSelectedNodes, poolingFunction, poolingSize, dimLayersMLP,
                 bias, GSO, order=None, attentionMode="dense", *,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__(dimNodeSignals, nAttentionHeads, bias, nonlinearity,
                         nSelectedNodes, poolingFunction, poolingSize,
                         dimLayersMLP, GSO, order, "dense", device, generator,
                         attentionMode=attentionMode)


class GraphConvolutionAttentionNetwork(_SelectionBase):
    """GCAT stack (K-tap filters over the learned attention GSO).
    Reference: architectures.py:3815-4087. attentionMode as
    GraphAttentionNetwork."""

    filter_kind = "gcat"

    def __init__(self, dimNodeSignals, nFilterTaps, nAttentionHeads, bias,
                 nonlinearity, nSelectedNodes, poolingFunction, poolingSize,
                 dimLayersMLP, GSO, order=None, attentionMode="dense", *,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__(dimNodeSignals, nFilterTaps, bias, nonlinearity,
                         nSelectedNodes, poolingFunction, poolingSize,
                         dimLayersMLP, GSO, order, "dense", device, generator,
                         taps2=nAttentionHeads, attentionMode=attentionMode)


class EdgeVariantAttention(_SelectionBase):
    """Edge-variant filters parameterized by per-hop attention.
    Reference: architectures.py:4088-4356. attentionMode as
    GraphAttentionNetwork."""

    filter_kind = "ev_attention"

    def __init__(self, dimNodeSignals, nFilterTaps, nAttentionHeads, bias,
                 nonlinearity, nSelectedNodes, poolingFunction, poolingSize,
                 dimLayersMLP, GSO, order=None, attentionMode="dense", *,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__(dimNodeSignals, nFilterTaps, bias, nonlinearity,
                         nSelectedNodes, poolingFunction, poolingSize,
                         dimLayersMLP, GSO, order, "dense", device, generator,
                         taps2=nAttentionHeads, attentionMode=attentionMode)
