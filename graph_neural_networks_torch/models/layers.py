"""Parameterized graph layers (torch.nn).

The port of the JAX package's ``models/layers.py`` for the ported slices:
GraphFilter, NoPool and MaxPoolLocal, and the attention layers
GraphAttentional, GraphFilterAttentional and EdgeVariantAttentional. As
there, the GSO and the pooling tables are call arguments, not module
state, and the filter layers keep the zero-pad/slice contract of selection
pooling: pad x from its node count up to the GSO's N, filter, slice back.
Parameter names and shapes equal the JAX ones, so flax parameters load one
to one (utils.params).

Signals: x is (B, F, N).
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn

from graph_neural_networks_torch.ops import filters
from graph_neural_networks_torch.ops import gso as gso_lib


def uniform_parameter(shape, bound: float, generator: torch.Generator,
                      device) -> nn.Parameter:
    """U(-bound, bound) drawn on the CPU from `generator`, then moved to
    `device`, so one seed gives the same weights on every device."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return nn.Parameter(((2 * u - 1) * bound).to(device))


def _gso_n(S) -> int:
    if isinstance(S, gso_lib.Gso):
        return S.n
    n = getattr(S, "n", None)  # duck-typed GSOs (parallel.ShardedGso)
    if isinstance(n, int):
        return n
    return S.shape[-1]


def pad_slice(fn, x: torch.Tensor, N: int) -> torch.Tensor:
    """Apply `fn` under the zero-pad/slice contract: pad the last axis of x
    up to N, run, slice back to the input's node count."""
    n_in = x.shape[-1]
    if n_in < N:
        x = nn.functional.pad(x, (0, N - n_in))
    y = fn(x)
    return y[..., :n_in] if n_in < N else y


class GraphFilter(nn.Module):
    """LSIGF layer. Params: weight (F,E,K,G), bias (F,1), both
    U(-1/sqrt(G*K), 1/sqrt(G*K))."""

    def __init__(self, in_features: int, out_features: int,
                 filter_taps: int, edge_features: int = 1,
                 use_bias: bool = True, *, generator: torch.Generator,
                 device):
        super().__init__()
        G, F, K, E = in_features, out_features, filter_taps, edge_features
        stdv = 1.0 / math.sqrt(G * K)
        self.weight = uniform_parameter((F, E, K, G), stdv, generator, device)
        self.bias = (uniform_parameter((F, 1), stdv, generator, device)
                     if use_bias else None)

    def forward(self, x: torch.Tensor, S) -> torch.Tensor:
        return pad_slice(lambda xp: filters.lsigf(self.weight, S, xp,
                                                  self.bias), x, _gso_n(S))


class NoPool(nn.Module):
    """Identity with the pooling interface."""

    def __init__(self, n_input_nodes: int, n_output_nodes: int,
                 n_hops: int = 0):
        super().__init__()
        self.n_input_nodes = n_input_nodes
        self.n_output_nodes = n_output_nodes

    def forward(self, x: torch.Tensor, nbh_table=None) -> torch.Tensor:
        return x


class MaxPoolLocal(nn.Module):
    """Selection pooling: gather each kept node's neighborhood (restricted
    to kept nodes) and take the max. nbh_table is the host-precomputed
    (nOut, max_nbr) self-padded table."""

    def __init__(self, n_input_nodes: int, n_output_nodes: int,
                 n_hops: int = 0):
        super().__init__()
        self.n_input_nodes = n_input_nodes
        self.n_output_nodes = n_output_nodes

    def forward(self, x: torch.Tensor, nbh_table: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != self.n_input_nodes:
            raise ValueError(f"MaxPoolLocal expects {self.n_input_nodes} "
                             f"nodes, got {x.shape[-1]}")
        return x[..., nbh_table].amax(dim=-1)      # B x F x nOut x max_nbr


# ===========================================================================
# Attention layers
# ===========================================================================

def _heads_out(y: torch.Tensor, nonlinearity: Callable,
               concatenate: bool) -> torch.Tensor:
    """Multi-head output (B, P, F, N): concatenate (nonlinearity first;
    feature p*F + f) or average the heads (reference
    graphML.py:2950-2963)."""
    B, P, F, N = y.shape
    if concatenate:
        y = nonlinearity(y)
        return y.permute(0, 3, 1, 2).reshape(B, N, P * F).transpose(1, 2)
    return nonlinearity(y.mean(dim=1))


class GraphAttentional(nn.Module):
    """GAT layer. Params: mixer (K,E,2F), weight (K,E,F,G) with K = heads,
    U(-1/sqrt(G*K), 1/sqrt(G*K)). Reference: graphML.py:2849-2977."""

    def __init__(self, in_features: int, out_features: int,
                 attention_heads: int, edge_features: int = 1,
                 nonlinearity: Callable = torch.relu,
                 concatenate: bool = True, *, generator: torch.Generator,
                 device):
        super().__init__()
        G, F, K, E = (in_features, out_features, attention_heads,
                      edge_features)
        stdv = 1.0 / math.sqrt(G * K)
        self.mixer = uniform_parameter((K, E, 2 * F), stdv, generator, device)
        self.weight = uniform_parameter((K, E, F, G), stdv, generator, device)
        self.nonlinearity = nonlinearity
        self.concatenate = concatenate

    def forward(self, x: torch.Tensor, S) -> torch.Tensor:
        def run(xp):
            y = filters.graph_attention(xp, self.mixer, self.weight, S)
            return _heads_out(y, self.nonlinearity, self.concatenate)
        return pad_slice(run, x, _gso_n(S))


class GraphFilterAttentional(nn.Module):
    """GCAT layer: K-tap LSIGF over the learned attention GSO.
    Params: mixer (P,E,2F), weight (P,E,F,G), filterWeight (E,K), bias
    (F,1), U(-1/sqrt(G*P), 1/sqrt(G*P)). Reference:
    graphML.py:2979-3124."""

    def __init__(self, in_features: int, out_features: int,
                 filter_taps: int, attention_heads: int,
                 edge_features: int = 1, use_bias: bool = True,
                 nonlinearity: Callable = torch.relu,
                 concatenate: bool = True, *, generator: torch.Generator,
                 device):
        super().__init__()
        G, F, K, P, E = (in_features, out_features, filter_taps,
                         attention_heads, edge_features)
        stdv = 1.0 / math.sqrt(G * P)
        self.mixer = uniform_parameter((P, E, 2 * F), stdv, generator, device)
        self.weight = uniform_parameter((P, E, F, G), stdv, generator, device)
        self.filterWeight = uniform_parameter((E, K), stdv, generator, device)
        self.bias = (uniform_parameter((F, 1), stdv, generator, device)
                     if use_bias else None)
        self.nonlinearity = nonlinearity
        self.concatenate = concatenate

    def forward(self, x: torch.Tensor, S) -> torch.Tensor:
        def run(xp):
            y = filters.gat_lsigf(self.filterWeight, xp, self.mixer,
                                  self.weight, S, self.bias)
            return _heads_out(y, self.nonlinearity, self.concatenate)
        return pad_slice(run, x, _gso_n(S))


class EdgeVariantAttentional(nn.Module):
    """Edge-variant filter parameterized by per-hop attention mechanisms.
    Params: mixer (P,K,E,2F), weight (P,K,E,F,G), bias (F,1),
    U(-1/sqrt(G*K), 1/sqrt(G*K)). Reference: graphML.py:3126-3270 (heads
    concatenate with P*F, as in the JAX package)."""

    def __init__(self, in_features: int, out_features: int,
                 filter_taps: int, attention_heads: int,
                 edge_features: int = 1, use_bias: bool = True,
                 nonlinearity: Callable = torch.relu,
                 concatenate: bool = True, *, generator: torch.Generator,
                 device):
        super().__init__()
        G, F, K, P, E = (in_features, out_features, filter_taps,
                         attention_heads, edge_features)
        stdv = 1.0 / math.sqrt(G * K)
        self.mixer = uniform_parameter((P, K, E, 2 * F), stdv, generator,
                                       device)
        self.weight = uniform_parameter((P, K, E, F, G), stdv, generator,
                                        device)
        self.bias = (uniform_parameter((F, 1), stdv, generator, device)
                     if use_bias else None)
        self.nonlinearity = nonlinearity
        self.concatenate = concatenate

    def forward(self, x: torch.Tensor, S) -> torch.Tensor:
        def run(xp):
            y = filters.gat_evgf(xp, self.mixer, self.weight, S, self.bias)
            return _heads_out(y, self.nonlinearity, self.concatenate)
        return pad_slice(run, x, _gso_n(S))
