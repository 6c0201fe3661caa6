"""Time-varying architectures: the decentralized-controller models of the
flocking task, with unit-delay information propagation.

The port of the JAX package's ``models/architectures_time.py`` for
``LocalGNN_DB``. At time t a node only uses information that has had time
to arrive over the graph, so every k-th filter tap applies k time-delayed
shifts (``ops.filters.lsigf_db``).

Two interfaces compute the same outputs:

  * the full-history ``forward(x, S)`` / ``split_forward`` over a
    (B,T,E,N,N) dense stack or an ``ops.ell.EllGso`` with leading axes
    (B,T): what the trainer differentiates;
  * the step interface for closed-loop rollouts, which carries the
    (K-1)-deep node-major tap registers across environment steps and
    shifts them once a step: ``rollout_step`` over a per-step graph, or
    ``rollout_step_shifted`` given the shift the grid environment's
    window pass computed (``rollout_payload`` rides its cell table).

Not ported: ``GraphRecurrentNN_DB`` and ``AggregationGNN_DB`` (ROADMAP
queue 1 item 6).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from graph_neural_networks_torch.models import layers as gll
from graph_neural_networks_torch.models.architectures import (
    MLP, resolve_activation)
from graph_neural_networks_torch.ops import ell as ell_lib
from graph_neural_networks_torch.ops import filters
from graph_neural_networks_torch.utils.device import resolve_device

__all__ = ["LocalGNN_DB"]


def _readout_apply(readout: MLP, z: torch.Tensor, sigma) -> torch.Tensor:
    """Per-node readout MLP on node-major z (..., F): nonlinearity between
    layers, never after the last."""
    for i, layer in enumerate(readout.layers):
        if i > 0:
            z = sigma(z)
        z = layer(z)
    return z


def _normalize_S(S):
    """An EllGso as it is; a dense (B,T,N,N) or (B,T,E,N,N) stack as an
    f32 (B,T,E,N,N) tensor (JAX ``_normalize_S``)."""
    if isinstance(S, ell_lib.EllGso):
        return S
    S = torch.as_tensor(S)
    if S.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        S = S.to(torch.float32)
    if S.dim() == 4:              # B x T x N x N -> add E
        S = S[:, :, None]
    if S.dim() != 5:
        raise ValueError(f"a dense GSO stack is (B,T,[E,]N,N), got "
                         f"{tuple(S.shape)}")
    return S


class GraphFilterDB(nn.Module):
    """Delayed time-varying graph filter: weight (F,E,K,G), bias (F,1),
    both U(-1/sqrt(G*K), 1/sqrt(G*K)); forward(x (B,T,G,N), S) ->
    (B,T,F,N)."""

    def __init__(self, in_features: int, out_features: int,
                 filter_taps: int, edge_features: int = 1,
                 use_bias: bool = True, *, generator: torch.Generator,
                 device):
        super().__init__()
        G, F, K, E = in_features, out_features, filter_taps, edge_features
        stdv = 1.0 / math.sqrt(G * K)
        self.weight = gll.uniform_parameter((F, E, K, G), stdv, generator,
                                            device)
        self.bias = (gll.uniform_parameter((F, 1), stdv, generator, device)
                     if use_bias else None)

    def forward(self, x: torch.Tensor, S) -> torch.Tensor:
        return filters.lsigf_db(self.weight, S, x, self.bias)


class LocalGNN_DB(nn.Module):
    """Stack of delayed graph filters + per-node readout.
    Reference: architecturesTime.py:33-272; JAX
    ``models/architectures_time.py:LocalGNN_DB``.

    The module holds its weights (``filters[l]``: GraphFilterDB,
    ``readout``: the MLP); ``utils.params.load_flax_params`` copies a JAX
    parameter tree into them.
    """

    def __init__(self, dimNodeSignals, nFilterTaps, bias, nonlinearity,
                 dimReadout, dimEdgeFeatures, *, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        if len(dimNodeSignals) != len(nFilterTaps) + 1:
            raise ValueError("dimNodeSignals needs one more entry than "
                             "nFilterTaps")
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator()
        self.E = int(dimEdgeFeatures)
        self.F = [int(f) for f in dimNodeSignals]
        self.taps = [int(k) for k in nFilterTaps]
        self.sigma = resolve_activation(nonlinearity)
        self.filters = nn.ModuleList(
            GraphFilterDB(self.F[l], self.F[l + 1], self.taps[l], self.E,
                          bias, generator=gen, device=dev)
            for l in range(len(self.taps)))
        self.readout = MLP(self.F[-1], dimReadout, self.sigma, bias,
                           generator=gen, device=dev)
        # finite causal memory: the last output depends on at most
        # sum(K_l - 1) + 1 past steps (chained delayed taps)
        self.causal_window = sum(k - 1 for k in self.taps) + 1

    def flax_names(self) -> dict:
        """flax leaf path -> (torch parameter, transpose?). The JAX
        _LocalDBCore names its filters GraphFilterDB_<l> (weight, bias) and
        its readout MLP "Readout" (not the MLP_0 of _ConvCore)."""
        names = {(f"GraphFilterDB_{l}", name): (p, False)
                 for l, f in enumerate(self.filters)
                 for name, p in f.named_parameters()}
        names.update(self.readout.flax_names("Readout"))
        return names

    # -- full history --------------------------------------------------------
    def split_forward(self, x: torch.Tensor, S):
        """x (B,T,F0,N), S a dense (B,T,[E,]N,N) stack or an EllGso with
        leading (B,T) -> (y (B,T,dimReadout[-1],N), the last filter
        layer's output (B,T,F_L,N))."""
        x = torch.as_tensor(x)
        if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
            x = x.to(torch.float32)
        S = _normalize_S(S)
        for layer in self.filters:
            x = self.sigma(layer(x, S))
        y = _readout_apply(self.readout, x.transpose(2, 3), self.sigma)
        return y.transpose(2, 3), x

    def forward(self, x: torch.Tensor, S) -> torch.Tensor:
        return self.split_forward(x, S)[0]

    # -- step mode (closed-loop rollouts) -----------------------------------
    def rollout_init(self, B: int, N: int, dtype=torch.float32):
        """Zeroed per-layer tap registers (B, N, E, K_l-1, G_l): an all-zero
        history."""
        dev = self.filters[0].weight.device
        return tuple(torch.zeros((B, N, self.E, k - 1, g), dtype=dtype,
                                 device=dev)
                     for k, g in zip(self.taps, self.F[:-1]))

    @property
    def payload_width(self) -> int:
        """Feature width of rollout_payload (excl. the E axis)."""
        return sum((k - 1) * g for k, g in zip(self.taps, self.F[:-1]))

    def rollout_payload(self, state) -> torch.Tensor:
        """Node-major concat (B,N,E,P) of every register the next step
        must shift by S_t (P = sum_l (K_l-1)·G_l): all layers shift by the
        same per-step GSO, so one wide shift serves them all."""
        B, N, E = state[0].shape[:3]
        return torch.cat([s.reshape(B, N, E, -1) for s in state], dim=-1)

    def rollout_step_shifted(self, state, x_t: torch.Tensor,
                             shifted: torch.Tensor):
        """One causal step given the ALREADY-shifted payload
        (S_t @ rollout_payload(state), (B,N,E,P) or (B,N,E*P)).
        x_t: (B,F0,N). Returns (state', y_t (B,dimReadout[-1],N))."""
        h = x_t.to(torch.float32).transpose(-1, -2)
        B, N, E = state[0].shape[:3]
        shifted = shifted.reshape(B, N, E, -1)
        new_state = []
        off = 0
        for l, layer in enumerate(self.filters):
            K, G = self.taps[l], self.F[l]
            wl = (K - 1) * G
            sl = shifted[..., off:off + wl].reshape(B, N, E, K - 1, G)
            off += wl
            reg, y = filters.tap_register_combine(layer.weight, layer.bias,
                                                  sl, h)
            new_state.append(reg)
            h = self.sigma(y)
        z = _readout_apply(self.readout, h, self.sigma)
        return tuple(new_state), z.transpose(-1, -2)

    def rollout_step(self, state, x_t: torch.Tensor, S_t):
        """One causal step: (state', y_t (B,dimReadout[-1],N)), y_t equal
        to ``forward`` on the full history at time t up to float
        association. x_t: (B,F0,N); S_t: EllGso with leading (B,) or dense
        (B,N,N)/(B,E,N,N). All layers' registers shift in ONE wide
        node-major shift, then combine per layer."""
        pay = self.rollout_payload(state)
        shifted = (filters.step_shift_rows(pay, S_t) if pay.shape[-1]
                   else pay)
        return self.rollout_step_shifted(state, x_t, shifted)
