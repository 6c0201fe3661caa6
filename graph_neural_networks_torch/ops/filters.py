"""Graph filter functionals, lowered to the graph shift.

Conventions (as in the JAX package's ``ops/filters.py``):
  x : (B, G, N) graph signals, h : (F, E, K, G) taps, S : (E, N, N) GSO,
  y : (B, F, N). Shift = row-vector right-multiplication ``x @ S``.

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

def tap_register_combine(w: torch.Tensor, b: Optional[torch.Tensor],
                         shifted: torch.Tensor, x_nm: torch.Tensor):
    """One causal step of a delayed graph filter given its ALREADY-shifted
    tap register S(t)·z_{0..K-2}(t-1): build the tap stack and contract it
    with the taps. The closed-loop rollouts get the shifted register from
    the grid environment's window pass (data.flocking.env_step_grid).

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
