"""Parameterized graph layers (torch.nn).

The port of the JAX package's ``models/layers.py`` for the ported slices:
GraphFilter, the static filter families (SpectralGF, NodeVariantGF,
EdgeVariantGF, GraphFilterARMA), the local activations
(MaxLocalActivation, MedianLocalActivation, NoActivation), NoPool and
MaxPoolLocal, the attention layers GraphAttentional,
GraphFilterAttentional and EdgeVariantAttentional, and the static-GSO
hidden states of the recurrent family (HiddenState and its time-, node-
and edge-gated forms). As there,
the GSO and the structure tables are call arguments, not module state, and
the filter layers keep the zero-pad/slice contract of selection pooling:
pad x from its node count up to the GSO's N, filter, slice back.
Parameter names and shapes equal the JAX ones, so flax parameters load one
to one (utils.params; each layer's ``flax_names``).

Signals: x is (B, F, N), or (B, T, F, N) for the hidden states.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

from graph_neural_networks_torch.ops import attention_sparse as asp
from graph_neural_networks_torch.ops import filters
from graph_neural_networks_torch.ops import gso as gso_lib


def uniform_parameter(shape, bound: float, generator: torch.Generator,
                      device) -> nn.Parameter:
    """U(-bound, bound) drawn on the CPU from `generator`, then moved to
    `device`, so one seed gives the same weights on every device."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return nn.Parameter(((2 * u - 1) * bound).to(device))


def _own_names(module: nn.Module, scope: tuple) -> dict:
    """flax leaf path -> (parameter, False) for a layer whose parameters
    carry the flax names directly (no submodules)."""
    return {scope + (name,): (p, False)
            for name, p in module.named_parameters(recurse=False)}


def _gso_n(S) -> int:
    if isinstance(S, gso_lib.Gso):
        return S.n
    # duck-typed GSOs (parallel.ShardedGso, attention_sparse.EdgeList)
    n = getattr(S, "n", None)
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

    def flax_names(self, scope: tuple) -> dict:
        return _own_names(self, scope)


class SpectralGF(nn.Module):
    """Spectral-domain LSI filter with optional spline interpolation.

    Params: weight (F,E,G,M), bias (F,1), U(-1/sqrt(G*M), 1/sqrt(G*M)).
    Called with the eigenbasis V/VH (E,N,N) and, when M < N, the spline
    kernel (E,N,M) (utils.graph.spline_basis). Reference:
    graphML.py:2157-2315.
    """

    def __init__(self, in_features: int, out_features: int, n_coeffs: int,
                 edge_features: int = 1, use_bias: bool = True, *,
                 generator: torch.Generator, device):
        super().__init__()
        G, F, M, E = in_features, out_features, n_coeffs, edge_features
        stdv = 1.0 / math.sqrt(G * M)
        self.weight = uniform_parameter((F, E, G, M), stdv, generator, device)
        self.bias = (uniform_parameter((F, 1), stdv, generator, device)
                     if use_bias else None)

    def forward(self, x, V, VH, spline_kernel=None) -> torch.Tensor:
        N = V.shape[-1]
        if self.weight.shape[-1] == N:
            h = self.weight
        else:
            if spline_kernel is None:
                raise ValueError("SpectralGF with M < N needs the spline "
                                 "kernel")
            h = torch.einsum("enm,fegm->fegn", spline_kernel, self.weight)
        return pad_slice(lambda xp: filters.spectral_gf(h, V, VH, xp,
                                                        self.bias), x, N)


class NodeVariantGF(nn.Module):
    """Hybrid node-variant filter: M independent per-node taps, the other
    nodes copy their nearest selected node's tap (copy_nodes from
    utils.graph.nv_copy_nodes). Params: weight (F,E,K,G,M), bias (F,1),
    U(-1/sqrt(G*K*M), 1/sqrt(G*K*M)). Reference: graphML.py:2317-2509.
    """

    def __init__(self, in_features: int, out_features: int, shift_taps: int,
                 node_taps: int, edge_features: int = 1,
                 use_bias: bool = True, *, generator: torch.Generator,
                 device):
        super().__init__()
        G, F, K, M, E = (in_features, out_features, shift_taps, node_taps,
                         edge_features)
        stdv = 1.0 / math.sqrt(G * K * M)
        self.weight = uniform_parameter((F, E, K, G, M), stdv, generator,
                                        device)
        self.bias = (uniform_parameter((F, 1), stdv, generator, device)
                     if use_bias else None)

    def forward(self, x, S, copy_nodes) -> torch.Tensor:
        h = self.weight[..., copy_nodes]                  # F x E x K x G x N
        return pad_slice(lambda xp: filters.nvgf(h, S, xp, self.bias), x,
                         _gso_n(S))


class EdgeVariantGF(nn.Module):
    """(Hybrid) edge-variant filter. Reference: graphML.py:2511-2712.

    Dense parameterization (n_edges None): weightEV (F,E,K,G,N,N) masked
    by the graph's support (identity at k = 0). Edge-list
    parameterization (n_edges = nnz of the support): weightEV0 (F,E,G,N)
    on the diagonal and weightEVk (F,E,K-1,G,nnz) on the support edges,
    masked per edge feature by `valid`. When M < N also weightLSI
    (F,E,K,G), an LSIGF over the whole graph added to it (with the bias
    added a second time, as in the JAX layer). All U(-1/sqrt(G*K*N),
    1/sqrt(G*K*N)); bias (F,1).
    """

    def __init__(self, in_features: int, out_features: int, shift_taps: int,
                 selected_nodes: int, n_nodes: int, edge_features: int = 1,
                 use_bias: bool = True, n_edges: int = None, *,
                 generator: torch.Generator, device):
        super().__init__()
        G, F, K, M, N, E = (in_features, out_features, shift_taps,
                            selected_nodes, n_nodes, edge_features)
        stdv = 1.0 / math.sqrt(G * K * N)
        made = dict(generator=generator, device=device)
        self.edge_list = n_edges is not None
        if self.edge_list:
            self.weightEV0 = uniform_parameter((F, E, G, N), stdv, **made)
            self.weightEVk = (uniform_parameter((F, E, K - 1, G, n_edges),
                                                stdv, **made)
                              if K > 1 else None)
        else:
            self.weightEV = uniform_parameter((F, E, K, G, N, N), stdv,
                                              **made)
        self.bias = (uniform_parameter((F, 1), stdv, **made)
                     if use_bias else None)
        self.weightLSI = (uniform_parameter((F, E, K, G), stdv, **made)
                          if M < N else None)
        self.n_nodes = N

    def forward(self, x, S, identity_mask, shift_mask) -> torch.Tensor:
        b = self.bias
        if self.edge_list:
            # identity_mask: the (E, N) hybrid diagonal; shift_mask =
            # (row, col, valid (E, nnz))
            row, col, valid = shift_mask
            w0 = self.weightEV0 * identity_mask[None, :, None, :]
            wk = (None if self.weightEVk is None else
                  self.weightEVk * valid[None, :, None, None, :])

            def base(xp):
                return filters.evgf_edges(w0, wk, row, col, xp, b)
        else:
            K = self.weightEV.shape[2]
            E, N = identity_mask.shape[0], identity_mask.shape[-1]
            parts = [identity_mask[None, :, None, None]]
            if K > 1:
                parts.append(shift_mask[None, :, None, None].expand(
                    1, E, K - 1, 1, N, N))
            Phi = self.weightEV * torch.cat(parts, dim=2)

            def base(xp):
                return filters.evgf(Phi, xp, b)

        def run(xp):
            u = base(xp)
            if self.weightLSI is not None:
                u = u + filters.lsigf(self.weightLSI, S, xp, b)
            return u
        return pad_slice(run, x, self.n_nodes)


class GraphFilterARMA(nn.Module):
    """ARMA rational filter layer (Jacobi iterations). Reference:
    graphML.py:2714-2847.

    Params: inverseWeight (F,E,P,G) drawn from U(1 + 1/stdv, 1 + 2/stdv)
    to keep Sbar invertible, directWeight (F,E,P,G) and filterWeight
    (F,E,K,G) from U(-stdv, stdv), bias (F,1); stdv = 1/sqrt(G*P).
    """

    def __init__(self, in_features: int, out_features: int,
                 denominator_taps: int, residue_taps: int,
                 edge_features: int = 1, use_bias: bool = True,
                 t_max: int = 5, *, generator: torch.Generator, device):
        super().__init__()
        G, F, P, K, E = (in_features, out_features, denominator_taps,
                         residue_taps, edge_features)
        stdv = 1.0 / math.sqrt(G * P)
        made = dict(generator=generator, device=device)
        u = torch.rand((F, E, P, G), generator=generator,
                       dtype=torch.float32)
        self.inverseWeight = nn.Parameter((1 + (1 + u) / stdv).to(device))
        self.directWeight = uniform_parameter((F, E, P, G), stdv, **made)
        self.filterWeight = uniform_parameter((F, E, K, G), stdv, **made)
        self.bias = (uniform_parameter((F, 1), stdv, **made)
                     if use_bias else None)
        self.t_max = t_max

    def forward(self, x, S) -> torch.Tensor:
        return pad_slice(
            lambda xp: filters.jarma(self.inverseWeight, self.directWeight,
                                     self.filterWeight, S, xp, self.bias,
                                     t_max=self.t_max), x, _gso_n(S))


# ===========================================================================
# Local activations
# ===========================================================================

class MaxLocalActivation(nn.Module):
    """Localized max activation: a weighted sum of the k-hop neighborhood
    maxima, k = 0..K. Params: weight (1, K+1), U(-1/sqrt(K), 1/sqrt(K)).
    The neighbor tables nbh[k] (N, max_k) are host-precomputed and
    self-padded, so a pad is max-neutral. Reference: graphML.py:1535-1684.
    """

    def __init__(self, n_hops: int, *, generator: torch.Generator, device):
        super().__init__()
        self.n_hops = n_hops
        self.weight = uniform_parameter((1, n_hops + 1),
                                        1.0 / math.sqrt(n_hops), generator,
                                        device)

    def _features(self, x, nbh_tables, nbh_counts):
        if len(nbh_tables) != self.n_hops:
            raise ValueError(f"{len(nbh_tables)} neighbor tables for "
                             f"{self.n_hops} hops")
        return [x[..., tbl].amax(dim=-1) for tbl in nbh_tables]

    def forward(self, x, nbh_tables, nbh_counts=None) -> torch.Tensor:
        feats = [x] + self._features(x, nbh_tables, nbh_counts)
        xK = torch.stack(feats, dim=-1)                   # B x F x N x (K+1)
        return torch.einsum("bfnk,k->bfn", xK, self.weight[0])

    def flax_names(self, scope: tuple) -> dict:
        return _own_names(self, scope)


class MedianLocalActivation(MaxLocalActivation):
    """Localized median activation: as MaxLocalActivation with the lower
    median of each k-hop neighborhood (the reference's per-node medians,
    graphML.py:1772-1798): the self-padded table gathered, masked to +inf
    past each row's count, sorted, read at (count-1)//2."""

    def _features(self, x, nbh_tables, nbh_counts):
        feats = []
        for tbl, counts in zip(nbh_tables, nbh_counts):
            gathered = x[..., tbl]                        # B x F x N x max_k
            slot = torch.arange(tbl.shape[1], device=tbl.device)
            valid = slot[None, :] < counts[:, None]       # N x max_k
            srt = torch.where(valid, gathered, torch.inf).sort(dim=-1).values
            med_idx = ((counts - 1) // 2)[:, None]        # the lower median
            feats.append(srt.gather(
                -1, med_idx.expand(srt.shape[:-1] + (1,)))[..., 0])
        return feats


class NoActivation(nn.Module):
    """Identity with the activation interface (graphML.py:1816-1842)."""

    def forward(self, x, *_, **__):
        return x


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


# ===========================================================================
# Static-GSO hidden states (the recurrent family)
# ===========================================================================

def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``nn.functional.linear``; in bf16 the product accumulated in f32 and
    rounded once, as the JAX package's bf16 dot, through an f32 GEMM: with
    cuBLAS's reduced-precision reductions off (utils/device.py) a bf16 GEMM
    of few outputs and a long contraction (band_n4096's readout, 262,144
    inputs to 5) runs unsplit, 42 ms on an H100 against 0.33 ms in f32."""
    if x.dtype == torch.bfloat16:
        b = None if bias is None else bias.float()
        return nn.functional.linear(x.float(), weight.float(),
                                    b).to(x.dtype)
    return nn.functional.linear(x, weight, bias)


class Dense(nn.Module):
    """flax ``nn.Dense`` with torch's layout: weight (out, in) (the flax
    kernel (in, out) transposed), bias (out,); flax's init, a
    LeCun-normal kernel and a zero bias."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True, *, generator: torch.Generator,
                 device):
        super().__init__()
        w = torch.randn((out_features, in_features), generator=generator,
                        dtype=torch.float32) / math.sqrt(in_features)
        self.weight = nn.Parameter(w.to(device))
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device))
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias)

    def flax_names(self, scope: tuple) -> dict:
        names = {scope + ("kernel",): (self.weight, True)}
        if self.bias is not None:
            names[scope + ("bias",)] = (self.bias, False)
        return names


class HiddenState(nn.Module):
    """Static-GSO GRNN hidden-state layer (the ungated GatedGRNN).
    Params: aWeights (H,E,K,F), bWeights (H,E,K,H), xBias and zBias
    (H,1), U(-1/sqrt(F*K), 1/sqrt(F*K)). forward(x (B,T,F,N), z0
    (B,H,N), S) -> (z (B,T,H,N), z[:, -1:]). Reference:
    graphML.py:3540-3681."""

    def __init__(self, signal_features: int, hidden_features: int,
                 filter_taps: int, nonlinearity: Callable = torch.tanh,
                 edge_features: int = 1, use_bias: bool = True, *,
                 generator: torch.Generator, device):
        super().__init__()
        self.nonlinearity = nonlinearity
        self._main_taps(signal_features, hidden_features, filter_taps,
                        edge_features, use_bias, generator, device)

    def _main_taps(self, F, H, K, E, use_bias, generator, device):
        stdv = 1.0 / math.sqrt(F * K)
        made = dict(generator=generator, device=device)
        self.aWeights = uniform_parameter((H, E, K, F), stdv, **made)
        self.bWeights = uniform_parameter((H, E, K, H), stdv, **made)
        self.xBias = (uniform_parameter((H, 1), stdv, **made)
                      if use_bias else None)
        self.zBias = (uniform_parameter((H, 1), stdv, **made)
                      if use_bias else None)

    def _recur(self, x, z0, S, q_hat=None, q_check=None, edge_gated=False):
        z = filters.gated_grnn(self.aWeights, self.bWeights, S, x, z0,
                               self.nonlinearity, q_hat=q_hat,
                               q_check=q_check, x_bias=self.xBias,
                               z_bias=self.zBias, edge_gated=edge_gated)
        return z, z[:, -1:]

    def forward(self, x, z0, S):
        return self._recur(x, z0, S)

    def flax_names(self, scope: tuple) -> dict:
        names = _own_names(self, scope)
        for name, child in self.named_children():
            names.update(child.flax_names(scope + (name,)))
        return names


class _GatedHiddenStateBase(HiddenState):
    """The {time,node,edge}-gated hidden states: the main a/b taps and two
    ungated gate GRNNs (inputGateGRNN, forgetGateGRNN; tanh, one edge
    feature, as in the JAX layer) whose states a mode-specific head maps to
    the gates. Reference: graphML.py:3683-4209.

    Kept from the JAX package (a documented divergence from the
    reference): the gate heads are real parameters that train; the
    reference creates them in addGSO after the optimizer collected its
    parameters, so they never train there.
    """

    def __init__(self, signal_features: int, hidden_features: int,
                 filter_taps: int, nonlinearity: Callable = torch.tanh,
                 edge_features: int = 1, use_bias: bool = True, *,
                 generator: torch.Generator, device):
        super().__init__(signal_features, hidden_features, filter_taps,
                         nonlinearity, edge_features, use_bias,
                         generator=generator, device=device)
        made = dict(generator=generator, device=device)
        self.inputGateGRNN = HiddenState(signal_features, hidden_features,
                                         filter_taps, use_bias=use_bias,
                                         **made)
        self.forgetGateGRNN = HiddenState(signal_features, hidden_features,
                                          filter_taps, use_bias=use_bias,
                                          **made)
        self._gate_heads(signal_features, hidden_features, filter_taps,
                         edge_features, use_bias, made)

    def _gate_states(self, x, z0, S):
        zhat, _ = self.inputGateGRNN(x, z0, S)
        zcheck, _ = self.forgetGateGRNN(x, z0, S)
        return zhat, zcheck


class TimeGatedHiddenState(_GatedHiddenStateBase):
    """Scalar gates per (b, t): q = sigmoid(Dense(flatten(z_gate))), the
    heads inputGateFC and forgetGateFC (H*N -> 1). Reference:
    graphML.py:3683-3855. N is fixed at construction (n_nodes)."""

    def __init__(self, *args, n_nodes: int, **kwargs):
        self.n_nodes = n_nodes
        super().__init__(*args, **kwargs)

    def _gate_heads(self, F, H, K, E, use_bias, made):
        self.inputGateFC = Dense(H * self.n_nodes, 1, use_bias, **made)
        self.forgetGateFC = Dense(H * self.n_nodes, 1, use_bias, **made)

    def forward(self, x, z0, S):
        B, T, _, N = x.shape
        zhat, zcheck = self._gate_states(x, z0, S)
        H = zhat.shape[2]
        q_hat = torch.sigmoid(self.inputGateFC(
            zhat.reshape(B, T, H * N)))[:, :, None]        # B x T x 1 x 1
        q_check = torch.sigmoid(self.forgetGateFC(
            zcheck.reshape(B, T, H * N)))[:, :, None]
        return self._recur(x, z0, S, q_hat, q_check)


class NodeGatedHiddenState(_GatedHiddenStateBase):
    """Per-node gates: q = sigmoid(GraphFilter(H -> 1)(z_gate)), the heads
    inputGateGraphFilter and forgetGateGraphFilter. Reference:
    graphML.py:3857-4031."""

    def _gate_heads(self, F, H, K, E, use_bias, made):
        self.inputGateGraphFilter = GraphFilter(H, 1, K, 1, use_bias, **made)
        self.forgetGateGraphFilter = GraphFilter(H, 1, K, 1, use_bias,
                                                 **made)

    def forward(self, x, z0, S):
        B, T, _, N = x.shape
        zhat, zcheck = self._gate_states(x, z0, S)
        H = zhat.shape[2]
        q_hat = torch.sigmoid(self.inputGateGraphFilter(
            zhat.reshape(B * T, H, N), S)).reshape(B, T, 1, N)
        q_check = torch.sigmoid(self.forgetGateGraphFilter(
            zcheck.reshape(B * T, H, N), S)).reshape(B, T, 1, N)
        return self._recur(x, z0, S, q_hat, q_check)


class EdgeGatedHiddenState(_GatedHiddenStateBase):
    """Per-edge gates: q = the attention GSO of a single-head GAT over the
    gate state, which gates the GSO itself inside the filter. Params
    inputGateMixer/forgetGateMixer (1,E,2), inputGateWeight/
    forgetGateWeight (1,E,1,H), U(-1/sqrt(H), 1/sqrt(H)). The gates are
    (B, T, 1, N, N) on a dense GSO, and (B, T, 1, nnz), the attention
    coefficients of the support's edges, over an attention_sparse.EdgeList.
    Reference: graphML.py:4033-4209."""

    def _gate_heads(self, F, H, K, E, use_bias, made):
        stdv = 1.0 / math.sqrt(H)
        self.inputGateMixer = uniform_parameter((1, E, 2), stdv, **made)
        self.inputGateWeight = uniform_parameter((1, E, 1, H), stdv, **made)
        self.forgetGateMixer = uniform_parameter((1, E, 2), stdv, **made)
        self.forgetGateWeight = uniform_parameter((1, E, 1, H), stdv,
                                                  **made)

    def forward(self, x, z0, S):
        B, T, _, N = x.shape
        zhat, zcheck = self._gate_states(x, z0, S)
        H = zhat.shape[2]
        if isinstance(S, asp.EdgeList):
            # O(nnz) gates: the attention coefficients of the edges only,
            # consumed by gated_grnn's per-edge gated shift
            q_hat = asp.attention_coefficients_edges(
                zhat.reshape(B * T, H, N), self.inputGateMixer,
                self.inputGateWeight, S)[0][:, 0, 0]
            q_check = asp.attention_coefficients_edges(
                zcheck.reshape(B * T, H, N), self.forgetGateMixer,
                self.forgetGateWeight, S)[0][:, 0, 0]
            return self._recur(x, z0, S, q_hat.reshape(B, T, 1, -1),
                               q_check.reshape(B, T, 1, -1), edge_gated=True)
        q_hat = filters.attention_gso(
            zhat.reshape(B * T, H, N), self.inputGateMixer,
            self.inputGateWeight, S)[:, 0, 0]
        q_check = filters.attention_gso(
            zcheck.reshape(B * T, H, N), self.forgetGateMixer,
            self.forgetGateWeight, S)[:, 0, 0]
        return self._recur(x, z0, S, q_hat.reshape(B, T, 1, N, N),
                           q_check.reshape(B, T, 1, N, N))
