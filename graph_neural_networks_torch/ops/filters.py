"""Graph filter functionals, lowered to the graph shift.

Conventions (as in the JAX package's ``ops/filters.py``):
  x : (B, G, N) graph signals, h : (F, E, K, G) taps, S : (E, N, N) GSO,
  y : (B, F, N). Shift = row-vector right-multiplication ``x @ S``.

Time-varying: x : (B, T, G, N) with S a dense (B, T, E, N, N) stack or an
``ops.ell.EllGso`` (``lsigf_db``, the delayed filters of the flocking
controllers).

The attention family (GAT, GCAT, attention EVGF) runs in dense mode as
``torch.einsum`` over the materialized (B, P, E, N, N) coefficients, on a
band-mode Gso through the flash kernels of ``ops.attention_flash``
(coefficients never materialized), whatever the device, and on a
``parallel.ShardedGso`` node-sharded through ``parallel.attention``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from graph_neural_networks_torch.ops import attention_flash as af
from graph_neural_networks_torch.ops import ell as ell_lib
from graph_neural_networks_torch.ops import gso as gso_lib

INFINITE = af.INFINITE  # reference's additive -inf (graphML.py:73)


def lsigf(h: torch.Tensor, gso, x: torch.Tensor,
          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Linear shift-invariant graph filter (the graph convolution).

    y_f = sum_{e,k,g} h[f,e,k,g] (x_g S_e^k) + b_f.
    h: (F,E,K,G), x: (B,G,N), b: (F,1) -> y: (B,F,N).
    The shift register goes through :func:`gso.gshift_register` (the
    kernels); the tap contraction is one ``torch.einsum``.
    """
    F, E, K, G = h.shape
    B, G_, N = x.shape
    if G_ != G:
        raise ValueError(f"x has {G_} features, the filter takes {G}")
    xe = x[:, None].expand(B, E, G, N)
    z = gso_lib.gshift_register(gso, xe, K)              # B x E x K x G x N
    y = torch.einsum("bekgn,fekg->bfn", z, h)
    return y if b is None else y + b


# ---------------------------------------------------------------------------
# Time-varying (delayed) filters
# ---------------------------------------------------------------------------

def db_graph_shift(xe: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
    """One per-(batch, time) graph shift of xe: (B,T,E,G,N) by a dense
    (B,T,E,N,N) stack (an EllGso's shifts run node-major, in
    :func:`_lsigf_db_ell_rows`)."""
    return torch.einsum("btegn,btenm->btegm", xe, S)


def step_shift_rows(r: torch.Tensor, S_t) -> torch.Tensor:
    """One node-major graph shift of r (B,N,E,C) by a per-step GSO:
    ell.EllGso with leading (B,), or dense (B,N,N)/(B,E,N,N)."""
    if isinstance(S_t, ell_lib.EllGso):
        return S_t.db_shift_rows(r)
    S = torch.as_tensor(S_t)
    if S.dim() == 3:
        S = S[:, None]
    return torch.einsum("bnec,benm->bmec", r, S.to(r.dtype))


def tap_register_combine(w: torch.Tensor, b: Optional[torch.Tensor],
                         shifted: torch.Tensor, x_nm: torch.Tensor):
    """One causal step of a delayed graph filter given its ALREADY-shifted
    tap register S(t)·z_{0..K-2}(t-1): build the tap stack and contract it
    with the taps. The closed-loop rollouts get the shifted register from
    the grid environment's window pass (data.flocking.env_step_grid);
    :func:`tap_register_step` shifts it over a per-step graph.

    w: (F,E,K,G); b: (F,1) or None; shifted: (B,N,E,K-1,G); x_nm: (B,N,G).
    Returns (reg' (B,N,E,K-1,G), y (B,N,F)).
    """
    F, E, K, G = w.shape
    B, N, _ = x_nm.shape
    x0 = x_nm[:, :, None, None].expand(B, N, E, 1, G)
    stack = torch.cat([x0, shifted], dim=-2) if K > 1 else x0
    y = torch.einsum("bnekg,fekg->bnf", stack, w)
    if b is not None:
        y = y + b.reshape(-1)
    return stack[..., : K - 1, :], y


def tap_register_step(w: torch.Tensor, b: Optional[torch.Tensor],
                      reg: torch.Tensor, x_nm: torch.Tensor, S_t):
    """One causal step of a delayed graph filter on the node-major tap
    register: the recurrence z_k(t) = S(t)·z_{k-1}(t-1) that defines the
    DB family, shared by :func:`lsigf_db`'s ELL form and the
    architectures' ``rollout_step``, as in the JAX package.

    w: (F,E,K,G); reg: (B,N,E,K-1,G) holding z_{0..K-2}(t-1); x_nm:
    (B,N,G); S_t: ell.EllGso with leading (B,) or dense (B,[E,]N,N).
    Returns (reg' (B,N,E,K-1,G), y (B,N,F)).
    """
    F, E, K, G = w.shape
    B, N, _ = x_nm.shape
    if K > 1:
        r = reg.reshape(B, N, E, (K - 1) * G)
        shifted = step_shift_rows(r, S_t).reshape(B, N, E, K - 1, G)
    else:
        shifted = x_nm.new_zeros((B, N, E, 0, G))
    return tap_register_combine(w, b, shifted, x_nm)


def _lsigf_db_ell_rows(h: torch.Tensor, S, x: torch.Tensor,
                       b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ELL lsigf_db in the node-major layout: x (B,T,G,N) -> y (B,T,N,F).

    A Python loop over T carrying the K-1 deep delayed register
    node-major (the JAX package's ``lax.scan``): each step is ONE
    ``ell_shift_rows`` of row width E·(K-1)·G and one tap contraction.
    """
    F, E, K, G = h.shape
    B, T, _, N = x.shape
    xr = x.transpose(-1, -2)                           # B x T x N x G
    reg = x.new_zeros((B, N, E, K - 1, G))
    ys = []
    for t in range(T):
        reg, y = tap_register_step(h, None, reg, xr[:, t], S.time_step(t))
        ys.append(y)
    y = torch.stack(ys, dim=1)                         # B x T x N x F
    return y if b is None else y + b.reshape(-1)


def lsigf_db(h: torch.Tensor, S, x: torch.Tensor,
             b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Delayed LSIGF over a per-(batch, time) GSO.

    y(t) = sum_k h_k x(t-k) S(t-k+1)...S(t) (unit-delay information
    propagation for decentralized controllers; reference
    graphML.py:977-1094). h: (F,E,K,G), x: (B,T,G,N); S: dense
    (B,T,E,N,N) or an O(N·deg) ell.EllGso with leading axes (B,T).
    b: (F,1) or None. Returns (B,T,F,N).
    """
    if isinstance(S, ell_lib.EllGso):
        return _lsigf_db_ell_rows(h, S, x, b).transpose(-1, -2)
    F, E, K, G = h.shape
    B, T, _, N = x.shape
    xe = x[:, :, None].expand(B, T, E, G, N)
    zs = [xe]
    for _ in range(1, K):
        # shift down the time axis (zero-pad t=0), then shift on the graph
        xe = torch.cat([torch.zeros_like(xe[:, :1]), xe[:, :-1]], dim=1)
        xe = db_graph_shift(xe, S)
        zs.append(xe)
    z = torch.stack(zs, dim=2)                        # B x T x K x E x G x N
    y = torch.einsum("btkegn,fekg->btfn", z, h)
    return y if b is None else y + b


# ---------------------------------------------------------------------------
# Attention (GAT family)
# ---------------------------------------------------------------------------

def _sharded(gso) -> bool:
    """True for a parallel.ShardedGso (duck-typed, as in the JAX
    package): the functionals route to parallel.attention."""
    return hasattr(gso, "band_attention")


def _attention_band(gso) -> bool:
    """True for a band-mode Gso (the flash path), False for the dense path
    (any other Gso, or a raw (N, N)/(E, N, N) array). Raises for the GSO
    containers whose attention is not ported yet."""
    if isinstance(gso, gso_lib.Gso):
        return gso.mode == "band"
    if isinstance(gso, (torch.Tensor, np.ndarray)):
        return False
    raise NotImplementedError(
        f"attention over a {type(gso).__name__} (the edge-list path of "
        "ops/attention_sparse.py) is not ported yet (ROADMAP queue 1 item 8)")


def _dense(gso, x: torch.Tensor) -> torch.Tensor:
    """The (E, N, N) dense GSO in x's dtype, on x's device."""
    return torch.as_tensor(gso_lib.dense(gso), dtype=x.dtype,
                           device=x.device)


def _band_args(gso):
    return af.slab5(gso), gso.band_w, af.band_auxes(gso)


def attention_gso(x: torch.Tensor, a: torch.Tensor, W: torch.Tensor, gso,
                  negative_slope: float = 0.2) -> torch.Tensor:
    """Learn the attention GSO alpha_ij (GAT coefficients), dense.

    alpha^{ep}_{ij} = softmax_j(LeakyReLU(a2.Wx_i + a1.Wx_j)) masked to
    the S+I support with an additive -1e12 (reference graphML.py:640-737,
    including its exact masking arithmetic).
    x: (B,G,N), a: (P,E,2F), W: (P,E,F,G) -> aij: (B,P,E,N,N).
    """
    S = _dense(gso, x)
    E, N, _ = S.shape
    F = W.shape[2]
    Seye = S + torch.eye(N, dtype=S.dtype, device=S.device)[None]
    Wx = torch.einsum("pefg,bgn->bpefn", W, x)
    a1, a2 = a[..., :F], a[..., F:]
    a1Wx = torch.einsum("pef,bpefn->bpen", a1, Wx)
    a2Wx = torch.einsum("pef,bpefn->bpen", a2, Wx)
    # e_ij = a2.Wx_i (row i, the center) + a1.Wx_j (column j, the
    # neighbour), as the reference broadcasts them (graphML.py:713)
    eij = torch.nn.functional.leaky_relu(
        a2Wx[..., :, None] + a1Wx[..., None, :],
        negative_slope=negative_slope)                     # B,P,E,N,N
    mask = (Seye.abs().sum(0) > 1e-9).to(x.dtype)          # N x N
    aij = torch.softmax(eij * mask - (1 - mask) * INFINITE, dim=-1)
    return aij * mask


def graph_attention(x: torch.Tensor, a: torch.Tensor, W: torch.Tensor, gso,
                    negative_slope: float = 0.2) -> torch.Tensor:
    """GAT layer output: y^p_i = sum_e sum_j s^e_ij alpha^{ep}_ij W^{ep} x_j.

    Reference: graphML.py:739-809 (the output aggregates with the
    edge-weighted attention S * alpha). Returns (B, P, F, N).
    """
    if _sharded(gso):
        from graph_neural_networks_torch.parallel import attention as sha
        return sha.sharded_graph_attention(x, a, W, gso.band_attention)
    if _attention_band(gso):
        s5, w, auxes = _band_args(gso)
        return af.graph_attention_band_flash(
            x, a, W, s5, w, negative_slope=negative_slope, auxes=auxes)
    S = _dense(gso, x)
    aij = attention_gso(x, a, W, gso, negative_slope)
    Wx = torch.einsum("pefg,bgn->bpefn", W, x)
    y = torch.einsum("bpefn,bpenm->bpefm", Wx, S[None, None] * aij)
    return y.sum(dim=2)


def gat_lsigf(h: torch.Tensor, x: torch.Tensor, a: torch.Tensor,
              W: torch.Tensor, gso, b: Optional[torch.Tensor] = None,
              negative_slope: float = 0.2) -> torch.Tensor:
    """K-tap LSIGF over the learned attention GSO (GCAT).

    Reference: graphML.py:811-895. h: (E,K), x: (B,G,N), a: (P,E,2F),
    W: (P,E,F,G) -> y: (B,P,F,N).
    """
    if _sharded(gso):
        from graph_neural_networks_torch.parallel import attention as sha
        return sha.sharded_gat_lsigf(h, x, a, W, gso.band_attention, b)
    if _attention_band(gso):
        s5, w, auxes = _band_args(gso)
        return af.gat_lsigf_band_flash(h, x, a, W, s5, w, b, negative_slope,
                                       auxes=auxes)
    E, K = h.shape
    P, _, F, G = W.shape
    B, _, N = x.shape
    aij = attention_gso(x, a, W, gso, negative_slope)     # B,P,E,N,N
    # The filter-tap layout replicates the reference (graphML.py:863-865):
    # W.permute(0,3,1,2).reshape(P,F,E,1,G), a raw reinterpretation of W
    # when F != G, kept for parity.
    W_taps = W.permute(0, 3, 1, 2).reshape(P, F, E, 1, G)
    hW = h[None, None, :, :, None] * W_taps               # P,F,E,K,G
    xe = x[:, None, None].expand(B, P, E, G, N)
    zs = [xe]
    for _ in range(1, K):
        xe = torch.einsum("bpegn,bpenm->bpegm", xe, aij)
        zs.append(xe)
    z = torch.stack(zs, dim=3)                            # B,P,E,K,G,N
    y = torch.einsum("bpekgn,pfekg->bpfn", z, hW)
    return y if b is None else y + b


def gat_evgf(x: torch.Tensor, a: torch.Tensor, W: torch.Tensor, gso,
             b: Optional[torch.Tensor] = None,
             negative_slope: float = 0.2) -> torch.Tensor:
    """Edge-variant filter where each hop's matrix is its own attention GSO.

    Reference: graphML.py:897-969. a: (P,K,E,2F), W: (P,K,E,F,G) ->
    y: (B,P,F,N).
    """
    if _sharded(gso):
        from graph_neural_networks_torch.parallel import attention as sha
        return sha.sharded_gat_evgf(x, a, W, gso.band_attention, b)
    if _attention_band(gso):
        s5, w, auxes = _band_args(gso)
        return af.gat_evgf_band_flash(x, a, W, s5, w, b, negative_slope,
                                      auxes=auxes)
    S = _dense(gso, x)
    K = W.shape[1]
    W0x = torch.einsum("pefg,bgn->bpefn", W[:, 0], x)
    aij = attention_gso(x, a[:, 0], W[:, 0], gso, negative_slope)
    W0x = torch.einsum("bpefn,bpenm->bpefm", W0x, S[None, None] * aij)
    y = W0x
    for k in range(1, K):
        aij = attention_gso(x, a[:, k], W[:, k], gso, negative_slope)
        W0x = torch.einsum("bpefn,bpenm->bpefm", W0x, S[None, None] * aij)
        y = y + W0x
    y = y.sum(dim=2)
    return y if b is None else y + b
