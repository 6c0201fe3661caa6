"""Time-varying architectures: the decentralized-controller models of the
flocking task, with unit-delay information propagation.

The port of the JAX package's ``models/architectures_time.py``:
``LocalGNN_DB``, ``GraphRecurrentNN_DB`` and ``AggregationGNN_DB``. At
time t a node only uses information that has had time to arrive over the
graph, so every k-th filter tap applies k time-delayed shifts
(``ops.filters.lsigf_db``), the GRNN's hidden state keeps a register of
delayed states (``ops.filters.grnn_db``), and the aggregation GNN builds
its sequence from delayed shifts.

Two interfaces compute the same outputs:

  * the full-history ``forward(x, S)`` / ``split_forward`` over a
    (B,T,E,N,N) dense stack or an ``ops.ell.EllGso`` with leading axes
    (B,T): what the trainer differentiates;
  * the step interface for closed-loop rollouts, which carries the
    (K-1)-deep node-major tap registers across environment steps and
    shifts them once a step: ``rollout_step`` over a per-step graph, or
    ``rollout_step_shifted`` given the shift the grid environment's
    window pass computed (``rollout_payload`` rides its cell table).

The GRNN draws its initial hidden state z0 ~ N(0, 1) from a
``torch.Generator`` (seeded 0 when none is given, the JAX package's
``PRNGKey(0)`` default), or takes it as ``z0``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from graph_neural_networks_torch.models import layers as gll
from graph_neural_networks_torch.models.architectures import (
    MLP, _Conv1d, resolve_activation)
from graph_neural_networks_torch.ops import ell as ell_lib
from graph_neural_networks_torch.ops import filters
from graph_neural_networks_torch.utils.device import resolve_device

__all__ = ["LocalGNN_DB", "GraphRecurrentNN_DB", "AggregationGNN_DB"]


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


class HiddenStateDB(nn.Module):
    """GRNN hidden-state layer on a time-varying batch GSO: aWeights
    (H,E,K,F), bWeights (H,E,K,H), xBias and zBias (H,1), every one
    U(-1/sqrt(F*K), 1/sqrt(F*K)) (bWeights too, as in the JAX layer).
    forward(x (B,T,F,N), z0 (B,H,N), S) -> (z (B,T,H,N), z[:, -1:]).
    Reference: graphML.py:3395-3538."""

    def __init__(self, signal_features: int, hidden_features: int,
                 filter_taps: int, nonlinearity=torch.tanh,
                 edge_features: int = 1, use_bias: bool = True, *,
                 generator: torch.Generator, device):
        super().__init__()
        F, H, K, E = (signal_features, hidden_features, filter_taps,
                      edge_features)
        self.nonlinearity = nonlinearity
        stdv = 1.0 / math.sqrt(F * K)
        made = dict(generator=generator, device=device)
        self.aWeights = gll.uniform_parameter((H, E, K, F), stdv, **made)
        self.bWeights = gll.uniform_parameter((H, E, K, H), stdv, **made)
        self.xBias = (gll.uniform_parameter((H, 1), stdv, **made)
                      if use_bias else None)
        self.zBias = (gll.uniform_parameter((H, 1), stdv, **made)
                      if use_bias else None)

    def forward(self, x: torch.Tensor, z0: torch.Tensor, S):
        z = filters.grnn_db(self.aWeights, self.bWeights, S, x, z0,
                            self.nonlinearity, x_bias=self.xBias,
                            z_bias=self.zBias)
        return z, z[:, -1:]

    def flax_names(self, scope: tuple) -> dict:
        return {scope + (name,): (p, False)
                for name, p in self.named_parameters()}


class _TimeArchBase(nn.Module):
    """What the three architectures share (the JAX ``_TimeArchBase``):
    forward/apply give the readout output of ``split_forward``,
    single_node_forward one node's, parameter_count the weights'."""

    def forward(self, x: torch.Tensor, S, **kw) -> torch.Tensor:
        return self.split_forward(x, S, **kw)[0]

    def apply(self, x, S=None, **kw):
        """The readout output (B,T,dimReadout[-1],N); given only a
        function, nn.Module.apply, which calls it on every submodule."""
        if S is None and callable(x):
            return super().apply(x)
        return self.forward(x, S, **kw)

    def single_node_forward(self, x: torch.Tensor, S, nodes, **kw):
        """The output of one node per sample (an int for all, or one a
        sample): (B,T,dimReadout[-1])."""
        y = self.forward(x, S, **kw)                   # B x T x dim x N
        B = y.shape[0]
        if isinstance(nodes, int):
            nodes = [nodes] * B
        idx = torch.as_tensor([int(n) for n in nodes], device=y.device)
        return y[torch.arange(B, device=y.device), :, :, idx]

    def parameter_count(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def _device(self) -> torch.device:
        return next(self.parameters()).device


def _as_f32(x) -> torch.Tensor:
    """Signals compute in f32; bf16/f16 are kept (the JAX ``_as_compute``)."""
    x = torch.as_tensor(x)
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        x = x.to(torch.float32)
    return x


class LocalGNN_DB(_TimeArchBase):
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
        x = _as_f32(x)
        S = _normalize_S(S)
        for layer in self.filters:
            x = self.sigma(layer(x, S))
        y = _readout_apply(self.readout, x.transpose(2, 3), self.sigma)
        return y.transpose(2, 3), x

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


def _normal_z0(B: int, H: int, N: int, device, dtype, generator):
    """z0 ~ N(0, 1) of shape (B,H,N) from `generator`, or from a fresh one
    seeded 0 on `device` (the JAX package's PRNGKey(0) default)."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return torch.randn((B, H, N), generator=generator, device=device,
                       dtype=dtype)


class GraphRecurrentNN_DB(_TimeArchBase):
    """GRNN over a time-varying batch GSO: the hidden state z_t =
    sigma(A(S)x_t + B(S;t)z_{t-1}) (``hiddenState``, HiddenStateDB), a
    delayed output filter (``outputState``, GraphFilterDB) and a per-node
    readout. Reference: architecturesTime.py:273-528; JAX
    ``models/architectures_time.py:GraphRecurrentNN_DB``.

    z0 ~ N(0, 1) of shape (B,H,N) is drawn at every ``split_forward`` from
    `generator` (the Trainer passes its own, which advances every step),
    from a fresh generator seeded 0 when none is given, or passed as
    ``z0``. The recurrence has infinite memory: there is no causal
    window, and closed-loop rollouts run the step interface, which is
    exact against ``split_forward`` on the full history.
    """

    def __init__(self, dimInputSignals, dimOutputSignals, dimHiddenSignals,
                 nFilterTaps, bias, nonlinearityHidden, nonlinearityOutput,
                 nonlinearityReadout, dimReadout, dimEdgeFeatures, *,
                 device="cuda", generator: torch.Generator | None = None):
        super().__init__()
        if len(nFilterTaps) != 2:
            raise ValueError("nFilterTaps holds the hidden state's and the "
                             "output filter's taps")
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator()
        self.E = int(dimEdgeFeatures)
        self.F = int(dimInputSignals)
        self.H = int(dimHiddenSignals)
        self.taps = [int(k) for k in nFilterTaps]
        self.sigma_hidden = resolve_activation(nonlinearityHidden)
        self.rho_output = resolve_activation(nonlinearityOutput)
        self.sigma_readout = resolve_activation(nonlinearityReadout)
        made = dict(generator=gen, device=dev)
        self.hiddenState = HiddenStateDB(self.F, self.H, self.taps[0],
                                         self.sigma_hidden, self.E, bias,
                                         **made)
        self.outputState = GraphFilterDB(self.H, int(dimOutputSignals),
                                         self.taps[1], self.E, bias, **made)
        self.readout = MLP(int(dimOutputSignals), dimReadout,
                           self.sigma_readout, bias, **made)

    def flax_names(self) -> dict:
        """flax leaf path -> (torch parameter, transpose?): the JAX
        _GRNNDBCore's hiddenState, outputState and Readout."""
        names = self.hiddenState.flax_names(("hiddenState",))
        names.update({("outputState", name): (p, False)
                      for name, p in self.outputState.named_parameters()})
        names.update(self.readout.flax_names("Readout"))
        return names

    # -- full history --------------------------------------------------------
    def split_forward(self, x: torch.Tensor, S,
                      generator: torch.Generator | None = None, z0=None):
        """x (B,T,F,N), S a dense (B,T,[E,]N,N) stack or an EllGso with
        leading (B,T) -> (y (B,T,dimReadout[-1],N), the output filter's
        output after its nonlinearity (B,T,dimOutput,N))."""
        x = _as_f32(x)
        S = _normalize_S(S)
        B, T, _, N = x.shape
        if z0 is None:
            z0 = _normal_z0(B, self.H, N, x.device, x.dtype, generator)
        else:
            z0 = torch.as_tensor(z0, dtype=x.dtype, device=x.device)
        z, _ = self.hiddenState(x, z0, S)
        y_out = self.rho_output(self.outputState(z, S))
        y = _readout_apply(self.readout, y_out.transpose(2, 3),
                           self.sigma_readout)
        return y.transpose(2, 3), y_out

    # -- step mode (closed-loop rollouts) -----------------------------------
    def rollout_init(self, B: int, N: int, dtype=torch.float32, z0=None):
        """The initial recurrent state: the input filter's zeroed x taps
        (B,N,E,Ka-1,F), z0 node-major (B,N,H) (when not given, drawn from
        a generator seeded 0, as split_forward draws it without one), the
        hidden recurrence's zeroed delayed-z tail (B,N,E,Ka-1,H) and the
        output filter's zeroed z taps (B,N,E,Kb-1,H)."""
        Ka, Kb = self.taps
        dev = self._device()
        if z0 is None:
            z0 = _normal_z0(B, self.H, N, dev, dtype, None)
        z0 = torch.as_tensor(z0, dtype=dtype, device=dev)
        zeros = lambda k, g: torch.zeros((B, N, self.E, k - 1, g),
                                         dtype=dtype, device=dev)
        return (zeros(Ka, self.F), z0.transpose(-1, -2), zeros(Ka, self.H),
                zeros(Kb, self.H))

    @property
    def payload_width(self) -> int:
        """Feature width of rollout_payload (excl. the E axis)."""
        Ka, Kb = self.taps
        return (Ka - 1) * (self.F + self.H) + (Kb - 1) * self.H

    def rollout_payload(self, state) -> torch.Tensor:
        """Node-major concat (B,N,E,P) of the three registers the next
        step shifts by S_t: the input filter's x taps, the hidden
        recurrence's delayed-z tail and the output filter's z taps (P =
        (Ka-1)(F+H) + (Kb-1)H)."""
        xa_reg, _, z_tail, zo_reg = state
        B, N, E = xa_reg.shape[:3]
        return torch.cat([xa_reg.reshape(B, N, E, -1),
                          z_tail.reshape(B, N, E, -1),
                          zo_reg.reshape(B, N, E, -1)], dim=-1)

    def rollout_step_shifted(self, state, x_t: torch.Tensor,
                             shifted: torch.Tensor):
        """One recurrent step given S_t @ rollout_payload(state) ((B,N,E,P)
        or (B,N,E*P)). x_t: (B,F,N). Returns (state', y_t
        (B,dimReadout[-1],N))."""
        xa_reg, z_prev, z_tail, zo_reg = state
        B, N, E = xa_reg.shape[:3]
        Ka, Kb = self.taps
        F, H = self.F, self.H
        shifted = shifted.reshape(B, N, E, -1)
        o1 = (Ka - 1) * F
        o2 = o1 + (Ka - 1) * H
        sa = shifted[..., :o1].reshape(B, N, E, Ka - 1, F)
        sz = shifted[..., o1:o2].reshape(B, N, E, Ka - 1, H)
        so = shifted[..., o2:].reshape(B, N, E, Kb - 1, H)
        hs = self.hiddenState
        x_nm = x_t.to(torch.float32).transpose(-1, -2)
        xa_reg, ax = filters.tap_register_combine(hs.aWeights, hs.xBias,
                                                  sa, x_nm)
        z0b = z_prev[:, :, None, None].expand(B, N, E, 1, H)
        reg_b = torch.cat([z0b, sz], dim=-2) if Ka > 1 else z0b
        bz = torch.einsum("bnekj,hekj->bnh", reg_b, hs.bWeights)
        if hs.zBias is not None:
            bz = bz + hs.zBias.reshape(-1)
        z_t = self.sigma_hidden(ax + bz)
        zo_reg, y = filters.tap_register_combine(
            self.outputState.weight, self.outputState.bias, so, z_t)
        z = _readout_apply(self.readout, self.rho_output(y),
                           self.sigma_readout)
        new_state = (xa_reg, z_t, reg_b[..., : Ka - 1, :], zo_reg)
        return new_state, z.transpose(-1, -2)

    def rollout_step(self, state, x_t: torch.Tensor, S_t):
        """One recurrent step, exact against split_forward on the full
        history (the GRNN has infinite memory, so step mode is both the
        fast and the exact closed-loop form). The three registers shift
        in ONE wide node-major shift. S_t: EllGso with leading (B,) or
        dense (B,N,N)/(B,E,N,N)."""
        pay = self.rollout_payload(state)
        shifted = (filters.step_shift_rows(pay, S_t) if pay.shape[-1]
                   else pay)
        return self.rollout_step_shifted(state, x_t, shifted)


class AggregationGNN_DB(_TimeArchBase):
    """Aggregation GNN on delayed sequences, built in the forward (the GSO
    changes every step): per node the sequence [x(t), S(t)x(t-1),
    S(t)S(t-1)x(t-2), ...] of nExchanges delayed shifts, summed over the
    edge features, then a Conv1d stack with max pooling and a per-node
    readout. ``poolingFunction`` is ignored, as in JAX (the pooling is a
    max over windows of ``poolingSize``). Reference:
    architecturesTime.py:529-782; JAX
    ``models/architectures_time.py:AggregationGNN_DB``.
    """

    def __init__(self, dimFeatures, nFilterTaps, bias, nonlinearity,
                 poolingFunction, poolingSize, dimReadout, dimEdgeFeatures,
                 nExchanges, *, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        del poolingFunction
        if len(dimFeatures) != len(nFilterTaps) + 1:
            raise ValueError("dimFeatures needs one more entry than "
                             "nFilterTaps")
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator()
        self.E = int(dimEdgeFeatures)
        self.F = [int(f) for f in dimFeatures]
        self.taps = [int(k) for k in nFilterTaps]
        self.alpha = [int(a) for a in poolingSize]
        self.n_exchanges = int(nExchanges)
        n_seq = [self.n_exchanges + 1]
        for l in range(len(self.taps)):
            out_conv = n_seq[l] - (self.taps[l] - 1)
            n_seq.append(int((out_conv - (self.alpha[l] - 1) - 1)
                             / self.alpha[l] + 1))
        self.n_seq = n_seq
        self.sigma = resolve_activation(nonlinearity)
        made = dict(generator=gen, device=dev)
        self.convs = nn.ModuleList(
            _Conv1d(self.F[l], self.F[l + 1], self.taps[l], bias, **made)
            for l in range(len(self.taps)))
        self.readout = MLP(self.F[-1] * n_seq[-1], dimReadout, self.sigma,
                           bias, **made)
        self.causal_window = self.n_exchanges + 1

    def flax_names(self) -> dict:
        """flax leaf path -> (torch parameter, transpose?): the JAX
        _AggDBCore's Conv_<l> (the kernel (k, in, out) permuted to
        (out, in, k)) and Readout."""
        names = {}
        for l, conv in enumerate(self.convs):
            names[(f"Conv_{l}", "kernel")] = (conv.weight,
                                              _Conv1d.FLAX_KERNEL_PERM)
            if conv.bias is not None:
                names[(f"Conv_{l}", "bias")] = (conv.bias, False)
        names.update(self.readout.flax_names("Readout"))
        return names

    def _pool(self, z: torch.Tensor, l: int) -> torch.Tensor:
        a = self.alpha[l]
        if a <= 1:
            return z
        keep = (z.shape[-1] // a) * a
        return z[..., :keep].reshape(z.shape[0], z.shape[1], keep // a,
                                     a).amax(dim=-1)

    # -- full history --------------------------------------------------------
    def split_forward(self, x: torch.Tensor, S):
        """x (B,T,F0,N), S a dense (B,T,[E,]N,N) stack or an EllGso with
        leading (B,T) -> (y, y), y (B,T,dimReadout[-1],N)."""
        x = _as_f32(x)
        S = _normalize_S(S)
        B, T, F0, N = x.shape
        E, nE = self.E, self.n_exchanges

        def delay(xe):        # shift down the time axis, zero at t = 0
            return torch.cat([torch.zeros_like(xe[:, :1]), xe[:, :-1]],
                             dim=1)

        if isinstance(S, ell_lib.EllGso):
            # node-major throughout, the layout the ELL shift gathers in
            xe = x.transpose(-1, -2)[..., None, :].expand(B, T, N, E, F0)
            zs = [xe]
            for _ in range(nE):
                xe = S.db_shift_rows(delay(xe))
                zs.append(xe)
            z = torch.stack(zs, dim=3).sum(dim=4)      # B x T x N x nE+1 x F
            z = z.transpose(-1, -2)                    # B x T x N x F x nE+1
        else:
            xe = x[:, :, None].expand(B, T, E, F0, N)
            zs = [xe]
            for _ in range(nE):
                xe = filters.db_graph_shift(delay(xe), S)
                zs.append(xe)
            z = torch.stack(zs, dim=2).sum(dim=3)      # B x T x nE+1 x F x N
            z = z.permute(0, 1, 4, 3, 2)               # B x T x N x F x nE+1
        z = z.reshape(B * T * N, F0, nE + 1)
        for l, conv in enumerate(self.convs):
            z = self._pool(self.sigma(conv(z)), l)
        y = _readout_apply(self.readout,
                           z.reshape(B * T * N, self.F[-1] * self.n_seq[-1]),
                           self.sigma)
        y = y.reshape(B, T, N, -1).permute(0, 1, 3, 2)
        return y, y

    # -- step mode (closed-loop rollouts) -----------------------------------
    def rollout_init(self, B: int, N: int, dtype=torch.float32):
        """The zeroed delayed-aggregation register z_{0..nE-1}(t-1)
        (B,N,E,nE,F0)."""
        return torch.zeros((B, N, self.E, self.n_exchanges, self.F[0]),
                           dtype=dtype, device=self._device())

    @property
    def payload_width(self) -> int:
        """Feature width of rollout_payload (excl. the E axis)."""
        return self.n_exchanges * self.F[0]

    def rollout_payload(self, state) -> torch.Tensor:
        """The node-major (B,N,E,P) register the next step shifts by S_t
        (P = nExchanges·F0)."""
        B, N, E = state.shape[:3]
        return state.reshape(B, N, E, -1)

    def rollout_step_shifted(self, state, x_t: torch.Tensor,
                             shifted: torch.Tensor):
        """One causal step given S_t @ rollout_payload(state): the
        sequence [x_t, shifted register], the conv stack as tap matmuls
        (Conv_<l>: y = sum_dk z[:, dk:dk+Lout] @ kernel[dk]) and the
        readout. x_t: (B,F0,N). Returns (state', y_t
        (B,dimReadout[-1],N))."""
        B, _, N = x_t.shape
        F0, nE, E = self.F[0], self.n_exchanges, self.E
        x_nm = x_t.to(torch.float32).transpose(-1, -2)
        seq = x_nm[:, :, None, None].expand(B, N, E, 1, F0)
        if nE > 0:
            seq = torch.cat([seq, shifted.reshape(B, N, E, nE, F0)],
                            dim=-2)
        new_state = seq[..., :nE, :]
        zl = seq.sum(dim=2).reshape(B * N, nE + 1, F0)   # (BN, L, F)
        z = None
        for l, (conv, k) in enumerate(zip(self.convs, self.taps)):
            if z is not None:
                zl = z.transpose(-1, -2)
            ker = conv.weight                            # (out, in, k)
            Lout = zl.shape[1] - k + 1
            y = sum(zl[:, dk:dk + Lout, :] @ ker[:, :, dk].transpose(0, 1)
                    for dk in range(k))
            if conv.bias is not None:
                y = y + conv.bias
            z = self._pool(self.sigma(y.transpose(-1, -2)), l)
        y = _readout_apply(self.readout,
                           z.reshape(B * N, self.F[-1] * self.n_seq[-1]),
                           self.sigma)
        return new_state, y.reshape(B, N, -1).transpose(1, 2)

    def rollout_step(self, state, x_t: torch.Tensor, S_t):
        """One causal step of the delayed aggregation sequence and the
        conv stack, exact against split_forward on the full history at
        time t. S_t: EllGso with leading (B,) or dense (B,N,N)/(B,E,N,N)."""
        pay = self.rollout_payload(state)
        shifted = (filters.step_shift_rows(pay, S_t) if pay.shape[-1]
                   else pay)
        return self.rollout_step_shifted(state, x_t, shifted)
