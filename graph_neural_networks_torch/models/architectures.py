"""Architectures: SelectionGNN (with Graclus coarsening),
LocalActivationGNN, LocalGNN, the static filter families
(SpectralGNN, NodeVariantGNN, EdgeVariantGNN, LocalEdgeNet,
ARMAfilterGNN, LocalARMA) and the attention family
(GraphAttentionNetwork, GraphConvolutionAttentionNetwork,
EdgeVariantAttention) on the shared convolutional core; the aggregation
GNNs (AggregationGNN, MultiNodeAggregationGNN); and the static-GSO
recurrent family (GraphRecurrentNN, GatedGraphRecurrentNN).

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

Signals x: (B, F0, N); (B, T, F0, N) for the recurrent family.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import scipy.sparse
import torch
from torch import nn

from graph_neural_networks_torch.models import layers as gll
from graph_neural_networks_torch.ops import attention_sparse as asp
from graph_neural_networks_torch.ops import gso as gso_lib
from graph_neural_networks_torch.utils import graph as gt
from graph_neural_networks_torch.utils.device import resolve_device

__all__ = ["SelectionGNN", "LocalActivationGNN", "LocalGNN", "SpectralGNN",
           "NodeVariantGNN",
           "EdgeVariantGNN", "LocalEdgeNet", "ARMAfilterGNN", "LocalARMA",
           "AggregationGNN", "MultiNodeAggregationGNN",
           "GraphAttentionNetwork", "GraphConvolutionAttentionNetwork",
           "EdgeVariantAttention", "GraphRecurrentNN",
           "GatedGraphRecurrentNN", "resolve_activation", "TorchDense",
           "MLP"]

ATTENTION_KINDS = ("gat", "gcat", "ev_attention")
ATTENTION_MODES = ("dense", "band", "edge")
LOCAL_ACTIVATIONS = {"max_local": gll.MaxLocalActivation,
                     "median_local": gll.MedianLocalActivation}
STATIC_KINDS = ("graph_filter", "spectral", "node_variant", "edge_variant",
                "arma")

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
        return gll.linear(x, self.weight, self.bias)


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

    def flax_names(self, scope) -> dict:
        """flax leaf path -> (torch parameter, transpose?) of the stack the
        JAX model holds as `scope`/TorchDense_<i> (`scope` a name or a
        path tuple). A flax dense kernel is (fan_in, out); the torch weight
        is (out, fan_in)."""
        scope = scope if isinstance(scope, tuple) else (scope,)
        names = {}
        for i, layer in enumerate(self.layers):
            names[scope + (f"TorchDense_{i}", "kernel")] = (layer.weight,
                                                           True)
            if layer.bias is not None:
                names[scope + (f"TorchDense_{i}", "bias")] = (layer.bias,
                                                             False)
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
    """Stack of graph-filter layers plus readout: every kind of the JAX
    core. Filters graph_filter, the static families (spectral,
    node_variant, edge_variant, arma) and the attention filters (gat,
    gcat, ev_attention); activations pointwise or local (max_local,
    median_local over act_hops[l] hops: ``layers.MaxLocalActivation``,
    ``MedianLocalActivation``, tables ctx['act_nbh'], ctx['act_cnt']);
    pooling no_pool, max_local (selection) or coarsen (a max over
    pool_alpha[l] consecutive nodes of the coarsened order, each layer on
    its own level's GSO ctx['S'][l]); readout mlp or per_node.

    taps: K per layer (heads for gat; M spectral coefficients for
    spectral); taps2: the second per-layer int (node taps M for
    node_variant, selected nodes M for edge_variant, denominator taps P
    for arma, heads for gcat and ev_attention). edge_counts: the support's
    nnz per layer for edge_variant's edge-list parameterization (None:
    dense). Attention layers grow the features by concatenating their
    heads on inner layers (g_in = F[l] * heads[l-1]), average them on the
    last, and apply the nonlinearity themselves.
    """

    def __init__(self, *, filter_kind: str, dims: tuple, taps: tuple,
                 n_nodes: tuple, sigma: Callable, taps2: tuple = (),
                 act_kind: str = "pointwise", act_hops: tuple = (),
                 pool_kind: str = "max_local", readout_dims: tuple = (),
                 readout_kind: str = "mlp", use_bias: bool = True,
                 edge_features: int = 1, t_max: int = 5,
                 edge_counts: Optional[tuple] = None,
                 pool_alpha: tuple = (), generator: torch.Generator, device):
        super().__init__()
        for what, value, known in (
                ("filter", filter_kind, STATIC_KINDS + ATTENTION_KINDS),
                ("activation", act_kind,
                 ("pointwise",) + tuple(LOCAL_ACTIVATIONS)),
                ("pooling", pool_kind, ("no_pool", "max_local", "coarsen")),
                ("readout", readout_kind, ("mlp", "per_node"))):
            if value not in known:
                raise ValueError(f"unknown {what} kind {value!r}; one of "
                                 f"{known}")
        self.filter_kind = filter_kind
        self.dims, self.taps, self.taps2 = dims, taps, taps2
        self.n_nodes = n_nodes
        self.sigma = sigma
        self.t_max = t_max
        self.edge_counts = edge_counts
        self.pool_kind, self.readout_kind = pool_kind, readout_kind
        self.pool_alpha = pool_alpha
        self.filters = nn.ModuleList(
            self._make_filter(l, use_bias, edge_features, generator, device)
            for l in range(len(taps)))
        # the local activations' weights (none for pointwise ones)
        self.activations = (
            None if act_kind == "pointwise" else nn.ModuleList(
                LOCAL_ACTIVATIONS[act_kind](act_hops[l], generator=generator,
                                            device=device)
                for l in range(len(taps))))
        readout_in = (dims[-1] * n_nodes[-1] if readout_kind == "mlp"
                      else dims[-1])
        self.readout = MLP(readout_in, readout_dims, sigma, use_bias,
                           generator=generator, device=device)

    def _make_filter(self, l, use_bias, E, generator, device) -> nn.Module:
        F, K, kind = self.dims, self.taps, self.filter_kind
        made = dict(generator=generator, device=device)
        if kind == "graph_filter":
            return gll.GraphFilter(F[l], F[l + 1], K[l], E, use_bias, **made)
        if kind == "spectral":
            return gll.SpectralGF(F[l], F[l + 1], K[l], E, use_bias, **made)
        if kind == "node_variant":
            return gll.NodeVariantGF(F[l], F[l + 1], K[l], self.taps2[l], E,
                                     use_bias, **made)
        if kind == "edge_variant":
            n_edges = (None if self.edge_counts is None
                       else self.edge_counts[l])
            return gll.EdgeVariantGF(F[l], F[l + 1], K[l], self.taps2[l],
                                     self.n_nodes[0], E, use_bias, n_edges,
                                     **made)
        if kind == "arma":
            return gll.GraphFilterARMA(F[l], F[l + 1], self.taps2[l], K[l], E,
                                       use_bias, self.t_max, **made)
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

    def _activation(self, l: int, x, ctx):
        if self.filter_kind in ATTENTION_KINDS:
            return x           # the attention layers apply it inside
        if self.activations is None:
            return self.sigma(x)
        return self.activations[l](x, ctx["act_nbh"][l], ctx["act_cnt"][l])

    def _pool(self, l: int, x, ctx):
        if self.pool_kind == "no_pool":
            return x
        if self.pool_kind == "coarsen":
            # a power of 2 takes log2(alpha) coarsening levels at once: the
            # nested groups are consecutive, so one max over alpha nodes is
            # log2(alpha) pairwise poolings
            alpha = self.pool_alpha[l] if self.pool_alpha else 2
            if alpha <= 1:
                return x
            B, F, N = x.shape
            return x.reshape(B, F, N // alpha, alpha).amax(dim=-1)
        n_in, n_out = self.n_nodes[l], self.n_nodes[l + 1]
        if n_in == n_out and ctx["pool_nbh"][l] is None:
            return x
        return gll.MaxPoolLocal(n_in, n_out, 0)(x, ctx["pool_nbh"][l])

    def _filter(self, l: int, x, ctx):
        layer, kind = self.filters[l], self.filter_kind
        # coarsening: one dense GSO a level
        S = ctx["S"][l] if self.pool_kind == "coarsen" else ctx["S"]
        if kind == "spectral":
            spline = ctx["spline"][l] if ctx.get("spline") else None
            return layer(x, ctx["V"], ctx["VH"], spline)
        if kind == "node_variant":
            return layer(x, S, ctx["copy_nodes"][l])
        if kind == "edge_variant":
            return layer(x, S, ctx["ev_identity"], ctx["ev_pattern"][l])
        return layer(x, S)

    def forward(self, x: torch.Tensor, ctx: dict):
        # node reordering (and the coarsening's zero padding) by gather
        # map: map[j] = source node of slot j, or -1 for a fake (zero) node
        idx = ctx["order_map"]
        x = torch.where(idx >= 0, x[:, :, idx.clamp(min=0)], 0.0)
        for l in range(len(self.filters)):
            x = self._filter(l, x, ctx)
            x = self._activation(l, x, ctx)
            x = self._pool(l, x, ctx)
        y_gfl = x
        if self.readout_kind == "mlp":
            y = self.readout(x.reshape(x.shape[0], self.dims[-1] * x.shape[-1]))
        else:
            y = self.readout(x.transpose(1, 2)).transpose(1, 2)
        return y, y_gfl

    def flax_names(self) -> dict:
        """flax leaf path -> (torch parameter, transpose?). The JAX core
        names its submodules <LayerClass>_<i>, counted per class: filter
        layer l is <FilterClass>_<l> (GraphFilter_0, GraphAttentional_1,
        ...), whose parameters carry the torch layer's names (weight, bias,
        mixer, filterWeight), a local activation MaxLocalActivation_<l> or
        MedianLocalActivation_<l> (weight), and MLP_0 is the readout."""
        modules = list(enumerate(self.filters))
        if self.activations is not None:
            modules += list(enumerate(self.activations))
        names = {(f"{type(f).__name__}_{l}", name): (p, False)
                 for l, f in modules for name, p in f.named_parameters()}
        names.update(self.readout.flax_names("MLP_0"))
        return names


# ---------------------------------------------------------------------------
# Wrapper base
# ---------------------------------------------------------------------------

class _ArchBase:
    """Host-side architecture wrapper: owns the core module, the ctx dict
    of device tensors and the node order."""

    core: _ConvCore
    order: list
    device: torch.device
    # False: a bf16 forward computes in bf16 on the bf16 context. True for
    # the architectures whose JAX forward casts x to f32 and passes the
    # f32 context: under bf16 mixed precision their arithmetic is f32 on
    # bf16-rounded parameters (JAX's type promotion of bf16 parameters
    # against f32 activations).
    compute_f32 = False

    @property
    def ctx(self) -> dict:
        return self._ctx

    @ctx.setter
    def ctx(self, value: dict) -> None:
        # a new context (changeGSO, to, shard): drop the per-dtype casts
        self._ctx = value
        self._ctx_cast = {}

    def ctx_for_dtype(self, dtype: torch.dtype) -> dict:
        """ctx with its float tensors in `dtype` (f32: ctx itself), cast
        once by ``ops.gso.cast_ctx`` and memoized until ctx changes, so a
        bf16 step does not re-cast the band slabs, BCSR blocks and
        attention band structure (JAX ``_ctx_for_dtype``); an edge-list
        GSO by its s_val."""
        if dtype == torch.float32:
            return self.ctx
        if dtype not in self._ctx_cast:
            self._ctx_cast[dtype] = {k: gso_lib.cast_ctx(v, dtype)
                                     for k, v in self.ctx.items()}
        return self._ctx_cast[dtype]

    def parameters(self):
        return self.core.parameters()

    def parameter_count(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def flax_names(self) -> dict:
        return self.core.flax_names()

    def to(self, device) -> "_ArchBase":
        """Move parameters and ctx to `device` (in place, like nn.Module).
        A sharded model (:meth:`shard`) stays on its mesh: it takes only the
        mesh's home device and raises on any other."""
        dev = resolve_device(device)
        self.ctx = {k: _ctx_to(v, dev) for k, v in self.ctx.items()}
        self.core.to(dev)
        self.S = self.ctx.get("S")
        self.device = dev
        return self

    def shard(self, mesh, n_parts: int, order: str = "none",
              data_axis: Optional[str] = None) -> "_ArchBase":
        """Run this architecture's graph shifts and attention node-sharded
        over `mesh`'s 'graph' axis: ctx['S'] becomes a parallel.ShardedGso
        backed by a sparse band-slab partition of the ordered GSO (never a
        dense N x N on the device), and the model moves to the mesh's home
        device, where its inputs and outputs live. In place; returns self.

        order: 'none' keeps this architecture's own node ordering (exact
        parity with the unsharded forward; a halo ring only if that
        ordering is already banded). 'rcm' composes a locality-preserving
        reorder into the model's input gather map, allowed only for an
        architecture with one (not the GRNNs) and with identity pooling:
        selection pooling is position-semantic in the reference
        (graphML.py:2003-2019), so reordering would change it.
        data_axis: also shard the batch over this mesh axis (hybrid data x
        graph parallelism). Whatever the GSO's mode (an edge-list GSO
        too), ctx['S'] becomes the ShardedGso; a coarsened SelectionGNN,
        whose layers shift on per-level GSOs, raises.
        """
        if getattr(self, "coarsening", False):
            raise ValueError("coarsening uses per-level GSOs; shard() "
                             "supports the flat path")
        if order != "none":
            if "order_map" not in self.ctx:
                raise ValueError(
                    "order='rcm' needs an input gather map (use "
                    "order='none' for architectures without one, e.g. "
                    "GRNNs)")
            if getattr(self.core, "pool_kind", "no_pool") != "no_pool" and \
                    any(t is not None for t in self.ctx.get("pool_nbh", ())):
                raise ValueError("order='rcm' requires identity pooling "
                                 "(position-semantic selection pooling "
                                 "forbids reordering)")
            if getattr(self.core, "activations", None) is not None:
                raise ValueError("order='rcm' requires pointwise "
                                 "activations")
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
        self._ctx_cast = {}
        return self

    # -- forward contracts -------------------------------------------------
    def split_forward(self, x):
        """(readout output, last graph-filter-layer output), in x's dtype
        on the context cast to it (:meth:`ctx_for_dtype`) for a bf16,
        f16 or f32 x."""
        x = torch.as_tensor(x, device=self.device)
        if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
            x = x.to(torch.float32)   # f64/int inputs: compute in f32
        return self.core(x, self.ctx_for_dtype(x.dtype))

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
    GSO layout, pooling tables, the family's own structure tables
    (:meth:`_extra_ctx`), core. The attention family builds its GSO in
    ``attentionMode``: 'dense', 'band' (the flash kernels) or 'edge' (an
    ``attention_sparse.EdgeList``)."""

    readout_kind = "mlp"
    filter_kind = "graph_filter"

    def __init__(self, dims, taps, bias, nonlinearity, nSelectedNodes,
                 poolingFunction, poolingSize, readout_dims, GSO, order,
                 gsoMode, device, generator, taps2=(),
                 attentionMode="dense", t_max=5, act_kind="pointwise",
                 act_hops=()):
        GSO = _normalize_gso(GSO)
        if len(dims) != len(taps) + 1:
            raise ValueError(f"{len(dims)} signal dims for {len(taps)} layers")
        if attentionMode not in ATTENTION_MODES:
            raise ValueError(f"unknown attentionMode {attentionMode!r}; one "
                             f"of {ATTENTION_MODES}")
        self.device = resolve_device(device)
        self._cfg = dict(bias=bias, sigma=resolve_activation(nonlinearity),
                         dims=_as_tuple(dims), taps=_as_tuple(taps),
                         taps2=_as_tuple(taps2),
                         readout=_as_tuple(readout_dims),
                         pool=_resolve_pool(poolingFunction), t_max=t_max,
                         act_kind=act_kind, act_hops=_as_tuple(act_hops))
        self.E = GSO.shape[0]
        self.order_name = order
        self.gso_mode = (attentionMode if self.filter_kind in ATTENTION_KINDS
                         else gsoMode)
        self.core = None
        self._generator = (torch.Generator().manual_seed(0)
                           if generator is None else generator)
        self._build(GSO, nSelectedNodes, poolingSize)

    def _extra_ctx(self, S_np: np.ndarray, N_list: list) -> dict:
        """Subclass hook: the ctx entries the filter family derives from the
        ordered (E, N, N) GSO."""
        return {}

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
            "S": _make_gso(S_np, self.gso_mode, self.device),
            "order_map": torch.as_tensor(np.asarray(order), dtype=torch.long,
                                         device=self.device),
            "pool_nbh": (_pool_tables(S_np, N_list, alpha, L, self.device)
                         if pool_kind == "max_local" else (None,) * L),
        }
        self.ctx.update(self._extra_ctx(S_np, N_list))
        patterns = self.ctx.get("ev_pattern")
        edge_counts = (tuple(p[0].shape[0] for p in patterns)
                       if patterns and isinstance(patterns[0], tuple)
                       else None)
        self._set_core(N_list, pool_kind, edge_counts=edge_counts)

    def _set_core(self, N_list, pool_kind, **core_kw):
        """Build the core on the first build; on a rebuild (changeGSO) keep
        its parameters and take the new node counts."""
        cfg = self._cfg
        if self.core is None:
            self.core = _ConvCore(
                filter_kind=self.filter_kind, dims=cfg["dims"],
                taps=cfg["taps"], taps2=cfg["taps2"],
                n_nodes=tuple(N_list), sigma=cfg["sigma"],
                act_kind=cfg["act_kind"], act_hops=cfg["act_hops"],
                pool_kind=pool_kind, readout_dims=cfg["readout"],
                readout_kind=self.readout_kind, use_bias=cfg["bias"],
                edge_features=self.E, t_max=cfg["t_max"],
                generator=self._generator, device=self.device, **core_kw)
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


# ---------------------------------------------------------------------------
# Concrete architectures
# ---------------------------------------------------------------------------

class SelectionGNN(_SelectionBase):
    """Selection GNN: (GraphFilter -> sigma -> pooling) x L + global MLP.

    gsoMode: 'dense' (torch.einsum shifts), 'band' or 'bcsr' (the CUDA
    SpMM kernels on a CUDA device) or 'edge' (an attention_sparse
    EdgeList). coarsening=True (a single-edge-feature GSO only, as in
    JAX): Graclus coarsening (``utils.graph.coarsen``, drawing from the
    numpy Generator `rng`, a fresh unseeded one when None) replaces the
    ordering and the selection pooling: layer l filters on level l's dense
    GSO and max-pools poolingSize[l] (a power of 2) consecutive nodes of
    the coarsened order, whose fake nodes carry zeros.
    """

    def __init__(self, dimNodeSignals, nFilterTaps, bias, nonlinearity,
                 nSelectedNodes, poolingFunction, poolingSize, dimLayersMLP,
                 GSO, order=None, coarsening=False, gsoMode="dense", *,
                 rng: Optional[np.random.Generator] = None, device="cuda",
                 generator: Optional[torch.Generator] = None):
        # (the JAX SelectionGNN coarsens only single-edge-feature GSOs)
        self.coarsening = bool(coarsening) and \
            _normalize_gso(GSO).shape[0] == 1
        self._rng = rng
        super().__init__(dimNodeSignals, nFilterTaps, bias, nonlinearity,
                         nSelectedNodes, poolingFunction, poolingSize,
                         dimLayersMLP, GSO, order, gsoMode, device, generator)

    def _build(self, GSO, nSelectedNodes, poolingSize):
        if not self.coarsening:
            return super()._build(GSO, nSelectedNodes, poolingSize)
        L = len(self._cfg["taps"])
        # per-layer poolingSize (powers of 2): layer l takes log2(alpha_l)
        # binary coarsening levels (the reference forces alpha = 2,
        # architectures.py:246-248; JAX's documented divergence)
        alpha = [int(a) for a in (poolingSize or [2] * L)]
        if len(alpha) != L:
            raise ValueError(f"{len(alpha)} pooling sizes for {L} layers")
        k_levels = []
        for a in alpha:
            k = max(int(round(math.log2(a))), 0) if a > 1 else 0
            if 2 ** k != a and a != 1:
                raise ValueError(f"coarsening poolingSize must be a power "
                                 f"of 2, got {a}")
            k_levels.append(k)
        self.alpha = alpha
        graphs, order = gt.coarsen(GSO[0], levels=sum(k_levels),
                                   rng=self._rng)
        if order is None:                     # no pooling at all
            order = list(range(graphs[0].shape[0]))
        self.order = order
        offs = np.concatenate([[0], np.cumsum(k_levels)])
        N_list = [graphs[o].shape[0] for o in offs]
        order_map = np.full(N_list[0], -1, np.int64)
        for slot, src in enumerate(order):
            if src < GSO.shape[1]:
                order_map[slot] = src
        self.ctx = {
            "S": tuple(gso_lib.as_gso(graphs[o].toarray(), device=self.device)
                       for o in offs[:L]),
            "order_map": torch.as_tensor(order_map, device=self.device),
            "pool_nbh": (None,) * L,
        }
        self._set_core(N_list, "coarsen", pool_alpha=tuple(alpha))


class LocalActivationGNN(_SelectionBase):
    """Selection GNN with localized activations: after each filter a
    weighted sum of the node's k-hop neighborhood maxima
    (``nonlinearity`` 'max_local', 'MaxLocalActivation' or
    ``layers.MaxLocalActivation``) or lower medians ('median_local',
    'MedianLocalActivation' or any other class), k = 0..kHopActivation[l];
    the MLP readout uses ReLU. The neighborhood tables (self-padded, and
    their counts) are built once on the host. Reference:
    architectures.py:481-815.
    """

    def __init__(self, dimNodeSignals, nFilterTaps, bias, nonlinearity,
                 kHopActivation, nSelectedNodes, poolingFunction, poolingSize,
                 dimLayersMLP, GSO, order=None, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        act = nonlinearity if isinstance(nonlinearity, str) else (
            "max_local" if nonlinearity is gll.MaxLocalActivation
            else "median_local")
        act = {"MaxLocalActivation": "max_local",
               "MedianLocalActivation": "median_local"}.get(act, act)
        if act not in LOCAL_ACTIVATIONS:
            raise ValueError(f"unknown local activation {nonlinearity!r}")
        super().__init__(dimNodeSignals, nFilterTaps, bias, "relu",
                         nSelectedNodes, poolingFunction, poolingSize,
                         dimLayersMLP, GSO, order, "dense", device, generator,
                         act_kind=act, act_hops=kHopActivation)

    def _extra_ctx(self, S_np, N_list):
        dev = self.device
        nbh, cnt = [], []
        for l, khop in enumerate(self._cfg["act_hops"]):
            n_l = N_list[l + 1]
            tabs, cnts = [], []
            for k in range(1, khop + 1):
                lst = gt.compute_neighborhood(S_np, k, n_rows=n_l, nb=n_l,
                                              output_type="list")
                width = max(max((len(v) for v in lst), default=1), 1)
                tab = np.empty((n_l, width), np.int64)
                for i, v in enumerate(lst):
                    tab[i, :len(v)] = v
                    tab[i, len(v):] = i
                tabs.append(torch.as_tensor(tab, device=dev))
                cnts.append(torch.as_tensor([len(v) for v in lst],
                                            dtype=torch.long, device=dev))
            nbh.append(tuple(tabs))
            cnt.append(tuple(cnts))
        return {"act_nbh": tuple(nbh), "act_cnt": tuple(cnt)}


class LocalGNN(_SelectionBase):
    """Selection GNN with a per-node linear readout (+ single_node_forward).

    gsoMode (keyword only): 'dense' (the default, as the JAX LocalGNN,
    which passes its base's default), 'band' or 'bcsr' (the CUDA SpMM
    kernels on a CUDA device) or 'edge'. The JAX base class
    (``_SelectionVariant``) takes the same modes.
    """

    readout_kind = "per_node"

    def __init__(self, dimNodeSignals, nFilterTaps, bias, nonlinearity,
                 nSelectedNodes, poolingFunction, poolingSize, dimReadout,
                 GSO, order=None, *, gsoMode="dense", device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__(dimNodeSignals, nFilterTaps, bias, nonlinearity,
                         nSelectedNodes, poolingFunction, poolingSize,
                         dimReadout, GSO, order, gsoMode, device, generator)


class SpectralGNN(_SelectionBase):
    """Selection GNN with spectral filters: M coefficients a layer, on
    the GSO's eigenbasis (``np.linalg.eig``, real parts), through a cubic
    B-spline kernel over the eigenvalues when M < N. Reference:
    architectures.py:1185-1484. Like the JAX SpectralGNN it takes no
    gsoMode: the eigenbasis is dense.
    """

    filter_kind = "spectral"

    def __init__(self, dimNodeSignals, nCoeff, bias, nonlinearity,
                 nSelectedNodes, poolingFunction, poolingSize, dimLayersMLP,
                 GSO, order=None, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__(dimNodeSignals, nCoeff, bias, nonlinearity,
                         nSelectedNodes, poolingFunction, poolingSize,
                         dimLayersMLP, GSO, order, "dense", device, generator)

    def _extra_ctx(self, S_np, N_list):
        E, N, _ = S_np.shape
        V = np.zeros((E, N, N))
        VH = np.zeros((E, N, N))
        lam = np.zeros((E, N))
        for e in range(E):
            w, v = np.linalg.eig(S_np[e])
            lam[e], V[e] = w.real, v.real
            VH[e] = V[e].conj().T
        splines = tuple(
            None if M == N else torch.as_tensor(
                np.stack([gt.spline_basis(M, lam[e]) for e in range(E)]),
                dtype=torch.float32, device=self.device)
            for M in self._cfg["taps"])

        def f32(a):
            return torch.as_tensor(a, dtype=torch.float32, device=self.device)
        return {"V": f32(V), "VH": f32(VH), "spline": splines}


class NodeVariantGNN(_SelectionBase):
    """Selection GNN with hybrid node-variant filters (nShiftTaps K,
    nNodeTaps M a layer). Reference: architectures.py:1485-1720."""

    filter_kind = "node_variant"

    def __init__(self, dimNodeSignals, nShiftTaps, nNodeTaps, bias,
                 nonlinearity, nSelectedNodes, poolingFunction, poolingSize,
                 dimLayersMLP, GSO, order=None, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__(dimNodeSignals, nShiftTaps, bias, nonlinearity,
                         nSelectedNodes, poolingFunction, poolingSize,
                         dimLayersMLP, GSO, order, "dense", device, generator,
                         taps2=nNodeTaps)

    def _extra_ctx(self, S_np, N_list):
        return {"copy_nodes": tuple(
            torch.as_tensor(gt.nv_copy_nodes(S_np, M), dtype=torch.long,
                            device=self.device)
            for M in self._cfg["taps2"])}


class _EdgeVariantMixin:
    """The edge-variant filters' masks. evMode 'dense': (E, N, N) masks and
    (F,E,K,G,N,N) weights; 'edge': the support's union over E as (row,
    col) lists with a per-edge-feature `valid` mask, weights on the
    edges."""

    filter_kind = "edge_variant"

    def _check_ev_mode(self, evMode):
        if evMode not in ("dense", "edge"):
            raise ValueError(f"unknown evMode {evMode!r}; 'dense' or "
                             "'edge'")
        self.ev_mode = evMode

    def _extra_ctx(self, S_np, N_list):
        dev = self.device
        patterns, idents = [], None
        for M in self._cfg["taps2"]:
            ide, pat = gt.ev_sparsity_pattern(S_np, M)
            if self.ev_mode == "edge":
                row, col = np.nonzero(pat.sum(0) > 0)
                patterns.append((
                    torch.as_tensor(row, dtype=torch.long, device=dev),
                    torch.as_tensor(col, dtype=torch.long, device=dev),
                    torch.as_tensor(pat[:, row, col], dtype=torch.float32,
                                    device=dev)))
                if idents is None:
                    idents = np.einsum("enn->en", ide)
            else:
                patterns.append(torch.as_tensor(pat, dtype=torch.float32,
                                                device=dev))
                if idents is None:
                    idents = ide
        return {"ev_identity": torch.as_tensor(idents, dtype=torch.float32,
                                               device=dev),
                "ev_pattern": tuple(patterns)}


class EdgeVariantGNN(_EdgeVariantMixin, _SelectionBase):
    """Selection GNN with (hybrid) edge-variant filters (nShiftTaps K,
    nFilterNodes M a layer). Reference: architectures.py:1721-1956."""

    def __init__(self, dimNodeSignals, nShiftTaps, nFilterNodes, bias,
                 nonlinearity, nSelectedNodes, poolingFunction, poolingSize,
                 dimLayersMLP, GSO, order=None, evMode="dense", *,
                 device="cuda", generator: Optional[torch.Generator] = None):
        self._check_ev_mode(evMode)
        super().__init__(dimNodeSignals, nShiftTaps, bias, nonlinearity,
                         nSelectedNodes, poolingFunction, poolingSize,
                         dimLayersMLP, GSO, order, "dense", device, generator,
                         taps2=nFilterNodes)


class LocalEdgeNet(_EdgeVariantMixin, _SelectionBase):
    """Edge-variant filters and a per-node readout. Reference:
    architectures.py:1957-2242."""

    readout_kind = "per_node"

    def __init__(self, dimNodeSignals, nShiftTaps, nFilterNodes, bias,
                 nonlinearity, nSelectedNodes, poolingFunction, poolingSize,
                 dimReadout, GSO, order=None, evMode="dense", *,
                 device="cuda", generator: Optional[torch.Generator] = None):
        self._check_ev_mode(evMode)
        super().__init__(dimNodeSignals, nShiftTaps, bias, nonlinearity,
                         nSelectedNodes, poolingFunction, poolingSize,
                         dimReadout, GSO, order, "dense", device, generator,
                         taps2=nFilterNodes)


class ARMAfilterGNN(_SelectionBase):
    """Selection GNN with ARMA filters (nDenominatorTaps P, nResidueTaps K
    a layer; tMax Jacobi iterations). Reference: architectures.py:
    2243-2555."""

    filter_kind = "arma"

    def __init__(self, dimNodeSignals, nDenominatorTaps, nResidueTaps, bias,
                 nonlinearity, nSelectedNodes, poolingFunction, poolingSize,
                 dimLayersMLP, GSO, order=None, tMax=5, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__(dimNodeSignals, nResidueTaps, bias, nonlinearity,
                         nSelectedNodes, poolingFunction, poolingSize,
                         dimLayersMLP, GSO, order, "dense", device, generator,
                         taps2=nDenominatorTaps, t_max=tMax)


class LocalARMA(ARMAfilterGNN):
    """ARMA filters and a per-node readout. Reference:
    architectures.py:2556-2919."""

    readout_kind = "per_node"


class GraphAttentionNetwork(_SelectionBase):
    """GAT stack: heads concatenated on inner layers, averaged on the last.
    Reference: architectures.py:3575-3814.

    attentionMode: 'dense' (torch.einsum over the (B,P,E,N,N)
    coefficients), 'band' (the flash attention kernels on a CUDA device;
    their plain versions on the CPU) or 'edge' (the SDDMM and segment
    softmax of ``ops.attention_sparse`` on the S+I support's edge list,
    O(nnz) memory, plain torch on every device).
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


# ---------------------------------------------------------------------------
# Aggregation GNNs
# ---------------------------------------------------------------------------

class _Conv1d(nn.Module):
    """flax ``nn.Conv`` of one spatial axis with VALID padding, in torch's
    layout: weight (out, in, k) (the flax kernel (k, in, out) permuted),
    bias (out,); flax's init there, U(-1/sqrt(k*in), 1/sqrt(k*in)) (a
    variance scaling of 1/3, fan-in, uniform) and a zero bias. Both
    compute the cross-correlation."""

    FLAX_KERNEL_PERM = (2, 1, 0)

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 use_bias: bool = True, *, generator: torch.Generator,
                 device):
        super().__init__()
        bound = 1.0 / math.sqrt(kernel * in_channels)
        self.weight = gll.uniform_parameter((out_channels, in_channels,
                                             kernel), bound, generator,
                                            device)
        self.bias = (nn.Parameter(torch.zeros(out_channels, device=device))
                     if use_bias else None)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return nn.functional.conv1d(z, self.weight, self.bias)


class _AggCore(nn.Module):
    """Aggregation-sequence CNN: z = x SN, then a Conv1d stack, the MLP
    and the aggregation MLP. Reference: architectures.py:3172-3218.
    flax names: Conv_<l>, MLP_0, MLP_1."""

    def __init__(self, *, dims: tuple, taps: tuple, n_seq: tuple,
                 alpha: tuple, sigma: Callable, mlp_dims: tuple,
                 agg_mlp_dims: tuple, n_nodes: int, use_bias: bool,
                 edge_features: int, generator: torch.Generator, device):
        super().__init__()
        E = edge_features
        made = dict(generator=generator, device=device)
        self.dims, self.alpha, self.sigma = dims, alpha, sigma
        self.n_nodes, self.E = n_nodes, E
        self.convs = nn.ModuleList(
            _Conv1d(dims[l] * E, dims[l + 1] * E, taps[l], use_bias, **made)
            for l in range(len(taps)))
        self.mlp = MLP(dims[-1] * n_seq[-1] * E, mlp_dims, sigma, use_bias,
                       **made)
        self.agg = (n_nodes == 1 or len(agg_mlp_dims) > 0)
        mlp_out = mlp_dims[-1] if mlp_dims else dims[-1] * n_seq[-1] * E
        self.agg_mlp = MLP(mlp_out * n_nodes, agg_mlp_dims, sigma, use_bias,
                           **made)

    def forward(self, x: torch.Tensor, ctx: dict):
        B = x.shape[0]
        x = x[:, :, ctx["order_map"]]
        SN = ctx["SN"]                                 # nNodes x E x N x maxN
        n_nodes, E, _, maxN = SN.shape
        z = torch.einsum("bfn,pens->bpefs", x, SN)     # B x nNodes x E x F x maxN
        z = z.reshape(B * n_nodes, E * self.dims[0], maxN)
        for l, conv in enumerate(self.convs):
            z = self.sigma(conv(z))
            a = self.alpha[l]
            if a > 1:
                keep = (z.shape[-1] // a) * a
                z = z[..., :keep].reshape(z.shape[0], z.shape[1],
                                          keep // a, a).amax(dim=-1)
        y = self.mlp(z.reshape(B * n_nodes, -1))
        y = y.reshape(B, n_nodes, -1).transpose(1, 2)  # B x dim x nNodes
        if self.agg:
            y = self.agg_mlp(y.transpose(1, 2).reshape(B, -1))
        return y, y

    def flax_names(self, scope: tuple = ()) -> dict:
        names = {}
        for l, conv in enumerate(self.convs):
            names[scope + (f"Conv_{l}", "kernel")] = (
                conv.weight, _Conv1d.FLAX_KERNEL_PERM)
            if conv.bias is not None:
                names[scope + (f"Conv_{l}", "bias")] = (conv.bias, False)
        names.update(self.mlp.flax_names(scope + ("MLP_0",)))
        if self.agg:
            names.update(self.agg_mlp.flax_names(scope + ("MLP_1",)))
        return names


class AggregationGNN(_ArchBase):
    """Aggregation GNN: per selected node the aggregation sequence [x_i,
    (Sx)_i, (S^2 x)_i, ...] of maxN shifts (a dense (nNodes, E, N, maxN)
    table built on the host), then a regular CNN on it. Reference:
    architectures.py:2920-3229."""

    def __init__(self, dimFeatures, nFilterTaps, bias, nonlinearity,
                 poolingFunction, poolingSize, dimLayersMLP, GSO, order=None,
                 maxN=None, nNodes=1, dimLayersAggMLP=(), *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        GSO = _normalize_gso(GSO)
        self.device = resolve_device(device)
        generator = (torch.Generator().manual_seed(0) if generator is None
                     else generator)
        sigma = resolve_activation(nonlinearity)
        S_np, self.order = gt.permutation_by_name(order)(GSO)
        E, N, _ = S_np.shape
        L = len(nFilterTaps)
        self.maxN = N if maxN is None else min(maxN, N)
        # sequence-length bookkeeping through valid conv + pooling
        n_seq = [self.maxN]
        for l in range(L):
            out_conv = n_seq[l] - (nFilterTaps[l] - 1)
            n_seq.append(int((out_conv - (poolingSize[l] - 1) - 1)
                             / poolingSize[l] + 1))
        # SN: [delta_i, S delta_i, ...] per selected node
        delta = np.zeros((E, N, nNodes))
        for n in range(nNodes):
            delta[:, n, n] = 1.0
        SN = [delta.copy()]
        for _ in range(1, self.maxN):
            delta = S_np @ delta
            SN.append(delta.copy())
        SN = np.stack(SN, axis=1).transpose(3, 0, 2, 1)  # nNodes x E x N x maxN
        self.ctx = {
            "SN": torch.as_tensor(SN, dtype=torch.float32, device=self.device),
            "order_map": torch.as_tensor(np.asarray(self.order),
                                         dtype=torch.long, device=self.device),
        }
        self.S = None
        self.N = n_seq
        self.core = _AggCore(
            dims=_as_tuple(dimFeatures), taps=_as_tuple(nFilterTaps),
            n_seq=tuple(n_seq), alpha=_as_tuple(poolingSize), sigma=sigma,
            mlp_dims=_as_tuple(dimLayersMLP),
            agg_mlp_dims=_as_tuple(dimLayersAggMLP), n_nodes=nNodes,
            use_bias=bias, edge_features=E, generator=generator,
            device=self.device)


class MultiNodeAggregationGNN:
    """Outer layers of per-node AggregationGNNs with rotated node orders.
    Reference: architectures.py:3230-3574. The JAX parameter tree is
    ``{"inner": [[tree of inner[r][p]]], "mlp": tree of the MLP}``; its
    ``flax_names`` maps that tree. Its forward casts x to f32, as JAX's
    (``compute_f32``)."""

    compute_f32 = True

    def __init__(self, nSelectedNodes, nShifts, dimFeatures, nFilterTaps,
                 bias, nonlinearity, poolingFunction, poolingSize,
                 dimLayersMLP, GSO, order=None, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        GSO = _normalize_gso(GSO)
        self.device = resolve_device(device)
        generator = (torch.Generator().manual_seed(0) if generator is None
                     else generator)
        sigma = resolve_activation(nonlinearity)
        S_np, self.order = gt.permutation_by_name(order)(GSO)
        self.N_nodes = N = S_np.shape[1]
        self.P = list(nSelectedNodes)
        self.R = len(self.P)
        inner_orders = [list(range(N))]
        for p in range(1, max(self.P)):
            inner_orders.append([p] + [n for n in range(N) if n != p])
        self.inner_orders = inner_orders
        self.inner = []                                # [r][p] AggregationGNN
        for r in range(self.R):
            row = []
            for p in range(self.P[r]):
                io = inner_orders[p]
                sub_S = S_np[:, io, :][:, :, io]
                row.append(AggregationGNN(
                    dimFeatures[r], nFilterTaps[r], bias, sigma,
                    poolingFunction, poolingSize[r], [dimFeatures[r + 1][0]],
                    sub_S, order=None, maxN=nShifts[r], device=self.device,
                    generator=generator))
            self.inner.append(row)
        self._mlp = MLP(dimFeatures[-1][-1] * self.P[-1],
                        _as_tuple(dimLayersMLP), sigma, bias,
                        generator=generator, device=self.device)
        # one module over every parameter (the Model's checkpoints)
        self.core = nn.ModuleList([a.core for row in self.inner for a in row]
                                  + [self._mlp])
        self._order_t = torch.as_tensor(np.asarray(self.order),
                                        dtype=torch.long, device=self.device)
        self._inner_t = [torch.as_tensor(np.asarray(io), dtype=torch.long,
                                         device=self.device)
                         for io in inner_orders]

    def parameters(self):
        return self.core.parameters()

    def parameter_count(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def flax_names(self) -> dict:
        names = {}
        for r, row in enumerate(self.inner):
            for p, arch in enumerate(row):
                names.update(arch.core.flax_names(("inner", r, p, "params")))
        names.update(self._mlp.flax_names(("mlp", "params")))
        return names

    def to(self, device) -> "MultiNodeAggregationGNN":
        dev = resolve_device(device)
        for row in self.inner:
            for arch in row:
                arch.to(dev)
        self._mlp.to(dev)
        self._order_t = self._order_t.to(dev)
        self._inner_t = [t.to(dev) for t in self._inner_t]
        self.device = dev
        return self

    def apply(self, x):
        x = torch.as_tensor(x, device=self.device).to(torch.float32)
        B = x.shape[0]
        x = x[:, :, self._order_t]
        N = self.N_nodes
        for r in range(self.R):
            outs = [self.inner[r][p].apply(x[:, :, self._inner_t[p]])
                    for p in range(self.P[r])]
            y = torch.stack(outs, dim=2)               # B x F x P[r]
            if r < self.R - 1:
                x = (nn.functional.pad(y, (0, N - y.shape[2]))
                     if y.shape[2] < N else y)
        return self._mlp(y.reshape(B, -1))             # flatten F-major

    def split_forward(self, x):
        y = self.apply(x)
        return y, y

    def __call__(self, x):
        return self.apply(x)


# ---------------------------------------------------------------------------
# Recurrent architectures (static GSO)
# ---------------------------------------------------------------------------

_HIDDEN_STATES = {"plain": gll.HiddenState,
                  "time": gll.TimeGatedHiddenState,
                  "node": gll.NodeGatedHiddenState,
                  "edge": gll.EdgeGatedHiddenState}


class _GRNNCore(nn.Module):
    """hiddenState -> outputState GraphFilter -> rho -> per-node readout.
    Reference: architectures.py:4357-4662 (splitForward at :4533-4570).
    flax names: hiddenState, outputState, Readout."""

    def __init__(self, *, hidden_kind: str, dim_in: int, dim_out: int,
                 dim_hidden: int, taps: tuple, sigma_hidden: Callable,
                 rho_output: Callable, sigma_readout: Callable,
                 readout_dims: tuple, use_bias: bool, edge_features: int,
                 n_nodes: int, generator: torch.Generator, device):
        super().__init__()
        made = dict(generator=generator, device=device)
        extra = {"n_nodes": n_nodes} if hidden_kind == "time" else {}
        self.hiddenState = _HIDDEN_STATES[hidden_kind](
            dim_in, dim_hidden, taps[0], nonlinearity=sigma_hidden,
            edge_features=edge_features, use_bias=use_bias, **extra, **made)
        self.outputState = gll.GraphFilter(dim_hidden, dim_out, taps[1],
                                           edge_features, use_bias, **made)
        self.Readout = MLP(dim_out, readout_dims, sigma_readout, use_bias,
                           **made)
        self.rho_output = rho_output
        self.dim_hidden, self.dim_out = dim_hidden, dim_out

    def forward(self, x: torch.Tensor, z0: torch.Tensor, ctx: dict):
        B, T, F, N = x.shape
        S = ctx["S"]
        z, _ = self.hiddenState(x, z0, S)
        y = self.outputState(z.reshape(B * T, self.dim_hidden, N), S)
        y = self.rho_output(y).reshape(B, T, self.dim_out, N)
        y_out = y
        y = self.Readout(y.transpose(2, 3)).transpose(2, 3)
        return y, y_out

    def flax_names(self) -> dict:
        names = self.hiddenState.flax_names(("hiddenState",))
        names.update(self.outputState.flax_names(("outputState",)))
        names.update(self.Readout.flax_names("Readout"))
        return names


def _make_gso(GSO: np.ndarray, mode: str, device):
    """The GSO container by mode: 'dense'/'band'/'bcsr' -> ``gso.Gso``;
    'edge' -> the COO ``attention_sparse.EdgeList`` of the S+I support
    (gather and ``index_add_`` shifts, O(nnz))."""
    if mode == "edge":
        return asp.build_edge_list(GSO, device=device)
    return gso_lib.as_gso(GSO, mode=mode, device=device)


class GraphRecurrentNN(_ArchBase):
    """GRNN: z_t = sigma(A(S)x_t + B(S)z_{t-1}), a graph-filter output
    layer, a per-node readout. Reference: architectures.py:4357-4662.

    gsoMode: 'dense', 'band' or 'bcsr' (every step's shifts on the CUDA
    SpMM kernels on a CUDA device), or 'edge' (the COO EdgeList: gather
    and ``index_add_`` shifts; the edge gate on its nnz edges).
    x: (B, T, F, N) -> (B, T, dimReadout[-1], N).

    z0 ~ N(0, 1) of shape (B, H, N) is drawn at every forward, as in JAX,
    from `generator` (a torch.Generator on the model's device), or from a
    fresh generator seeded 0 (JAX's ``PRNGKey(0)`` default) when none is
    given; or passed as `z0`. ``Trainer`` passes its own generator, which
    advances every step.
    """

    hidden_kind = "plain"
    # the forward casts x to f32 and takes the f32 context, as JAX's
    compute_f32 = True

    def __init__(self, dimInputSignals, dimOutputSignals, dimHiddenSignals,
                 nFilterTaps, bias, nonlinearityHidden, nonlinearityOutput,
                 nonlinearityReadout, dimReadout, GSO, gsoMode="dense", *,
                 device="cuda", generator: Optional[torch.Generator] = None):
        GSO = _normalize_gso(GSO)
        self.device = resolve_device(device)
        generator = (torch.Generator().manual_seed(0) if generator is None
                     else generator)
        self.order = list(range(GSO.shape[1]))
        self.H = dimHiddenSignals
        self.gso_mode = gsoMode
        self.ctx = {"S": _make_gso(GSO, gsoMode, self.device)}
        self._S_sparse = [scipy.sparse.csr_matrix(m) for m in GSO]
        self.S = self.ctx["S"]
        self.core = _GRNNCore(
            hidden_kind=self.hidden_kind, dim_in=dimInputSignals,
            dim_out=dimOutputSignals, dim_hidden=dimHiddenSignals,
            taps=_as_tuple(nFilterTaps),
            sigma_hidden=resolve_activation(nonlinearityHidden),
            rho_output=resolve_activation(nonlinearityOutput),
            sigma_readout=resolve_activation(nonlinearityReadout),
            readout_dims=_as_tuple(dimReadout), use_bias=bias,
            edge_features=GSO.shape[0], n_nodes=GSO.shape[1],
            generator=generator, device=self.device)

    def split_forward(self, x, generator: Optional[torch.Generator] = None,
                      z0=None):
        """(readout output, output-layer output), both (B, T, ., N)."""
        x = torch.as_tensor(x, device=self.device)
        if x.dtype != torch.float32:
            x = x.to(torch.float32)
        B, T, F0, N = x.shape
        if z0 is None:
            z0 = self.draw_z0(B, N, generator)
        else:
            z0 = torch.as_tensor(z0, dtype=torch.float32, device=self.device)
        return self.core(x, z0, self.ctx)

    def draw_z0(self, B: int, N: int,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """z0 ~ N(0, 1), (B, H, N) f32 on the model's device, from
        `generator` or from a fresh one seeded 0."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        return torch.randn((B, self.H, N), generator=generator,
                           device=self.device)

    def apply(self, x, generator: Optional[torch.Generator] = None, z0=None):
        return self.split_forward(x, generator=generator, z0=z0)[0]

    def __call__(self, x, generator: Optional[torch.Generator] = None,
                 z0=None):
        return self.apply(x, generator=generator, z0=z0)

    def single_node_forward(self, x, nodes,
                            generator: Optional[torch.Generator] = None):
        """Output at specific (original-id) nodes, one per batch element:
        (B, T, dim)."""
        y = self.apply(x, generator=generator)         # B x T x dim x N
        B = y.shape[0]
        if isinstance(nodes, int):
            nodes = [nodes] * B
        order = list(self.order)
        perm_nodes = torch.as_tensor([order.index(int(n)) for n in nodes],
                                     device=y.device)
        return y[torch.arange(B, device=y.device), :, :, perm_nodes]

    def changeGSO(self, GSO):
        """A new GSO (same N for the time gate's heads), same parameters."""
        GSO = _normalize_gso(GSO)
        self._S_sparse = [scipy.sparse.csr_matrix(m) for m in GSO]
        self.ctx = {"S": _make_gso(GSO, self.gso_mode, self.device)}
        self.S = self.ctx["S"]

    change_gso = changeGSO


class GatedGraphRecurrentNN(GraphRecurrentNN):
    """Gated GRNN with time, node or edge gates (gateType). Reference:
    architectures.py:4663-4984. The edge gate's gates are (B, T, 1, N, N)
    on a dense GSO, (B, T, 1, nnz) with gsoMode='edge'."""

    def __init__(self, dimInputSignals, dimOutputSignals, dimHiddenSignals,
                 nFilterTaps, bias, nonlinearityHidden, nonlinearityOutput,
                 nonlinearityReadout, dimReadout, GSO, gateType="time",
                 gsoMode="dense", *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        if gateType not in ("time", "node", "edge"):
            raise ValueError(f"unknown gateType {gateType!r}; one of "
                             "'time', 'node', 'edge'")
        self.hidden_kind = gateType
        super().__init__(dimInputSignals, dimOutputSignals, dimHiddenSignals,
                         nFilterTaps, bias, nonlinearityHidden,
                         nonlinearityOutput, nonlinearityReadout, dimReadout,
                         GSO, gsoMode=gsoMode, device=device,
                         generator=generator)

