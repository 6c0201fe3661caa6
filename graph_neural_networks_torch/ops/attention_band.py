"""Banded block attention with the coefficients materialized: the plain
reference of a whole band-mode attention layer.

The port of the JAX package's ``ops/attention_band.py``. Every stage --
SDDMM scores, row softmax and the (S*alpha) aggregation -- runs on dense
(ibs x ibs) tiles of the band slab as ``torch`` reshapes and einsums, and
the coefficient tensor ``alpha_col (B,P,E,nb,W,ibs,ibs)`` lives in memory
(0.7 GB at N=16384, B=8, P=2). The model path never calls this module: a
band-mode Gso goes to ``ops.attention_flash``. The tests and
``chip_smoke.py`` hold the flash path against it, on the CPU and on the
card, at sizes where dense mode cannot run.

Orientation matches the reference exactly (graphML.py:713, 807): score
e_ij = LeakyReLU(a2.Wx_i + a1.Wx_j), softmax over each ROW i, output at
column m aggregates alpha-weighted rows.

Layout: the band slab (ops.spmm.dense_to_band) reshaped to
(E, nb, W, ibs, ibs) with W = 2w+1; slab[e, j, k] = S_e[block j+k-w,
block j] (output block-column j).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from graph_neural_networks_torch.ops.attention_flash import (INFINITE,
                                                             _diag_win,
                                                             _win)


def _blocks(v: torch.Tensor, nb: int, ibs: int) -> torch.Tensor:
    """(..., N) -> (..., nb, ibs), zero-padding N up to nb*ibs."""
    n = v.shape[-1]
    if n < nb * ibs:
        v = nn.functional.pad(v, (0, nb * ibs - n))
    return v.reshape(v.shape[:-1] + (nb, ibs))


def band_attention_coefficients(x, a, W_p, slab5, w,
                                negative_slope: float = 0.2):
    """Banded attention coefficients.

    x: (B,G,N), a: (P,E,2F), W_p: (P,E,F,G); slab5: (E,nb,W,ibs,ibs).
    Returns (alpha_col (B,P,E,nb,W,ibs,ibs) -- coefficients laid out like
    the slab (column-block major), Wx (B,P,E,F,N)).
    """
    E, nb, Wn, ibs, _ = slab5.shape
    F = W_p.shape[2]
    Wx = torch.einsum("pefg,bgn->bpefn", W_p, x)
    a1, a2 = a[..., :F], a[..., F:]
    a1Wx = torch.einsum("pef,bpefn->bpen", a1, Wx)  # pairs with column j
    a2Wx = torch.einsum("pef,bpefn->bpen", a2, Wx)  # pairs with row i
    a1b = _blocks(a1Wx, nb, ibs)                    # B,P,E,nb,ibs
    a2b = _blocks(a2Wx, nb, ibs)

    # support of S+I on the band, in ROW-major window layout:
    # sup_row[r, k'] = support block (rows r, cols r+k'-w)
    sup_col = slab5.abs().sum(0) > 1e-9             # nb,W,ibs,ibs
    sup_col[:, w] |= torch.eye(ibs, dtype=torch.bool, device=x.device)
    mask_row = _diag_win(torch.flip(sup_col.to(x.dtype), dims=(-3,)), w)

    # SDDMM on the band: scores[., r, k', p, q] = lrelu(a2[r,p] + a1[r+k'-w,q])
    a1w = _win(a1b, w)                              # B,P,E,nb,W,ibs
    e = nn.functional.leaky_relu(a2b[..., :, None, :, None]
                                 + a1w[..., None, :],
                                 negative_slope=negative_slope)
    e = e * mask_row - (1 - mask_row) * INFINITE    # reference masking
    # row softmax across the band (rows r, normalize over (k', q))
    rowmax = e.amax(dim=(-3, -1))                   # ..., nb, ibs(p)
    expe = torch.exp(e - rowmax[..., :, None, :, None])
    rowsum = expe.sum(dim=(-3, -1))
    alpha_row = expe / rowsum[..., :, None, :, None] * mask_row
    # re-lay out column-block major to match the slab:
    # alpha_col[j, k] = alpha_row[j+k-w, 2w-k]
    alpha_col = _diag_win(torch.flip(alpha_row, dims=(-3,)), w)
    return alpha_col, Wx


def _band_aggregate(v, coeff_col, w):
    """y[., f, col j] = sum_{k,p} coeff_col[., j, k, p, q]
    v[., f, row j+k-w, p].

    v: (..., F, N); coeff_col: (..., nb, W, ibs, ibs). Returns (..., F, N').
    """
    nb, ibs = coeff_col.shape[-4], coeff_col.shape[-1]
    vb = _blocks(v, nb, ibs)                        # ..., F, nb, ibs
    vw = _win(vb, w)                                # ..., F, nb, W, ibs
    y = torch.einsum("...jkpq,...fjkp->...fjq", coeff_col, vw)
    return y.reshape(y.shape[:-2] + (nb * ibs,))


def graph_attention_band(x, a, W_p, slab5, w, n_out: Optional[int] = None,
                         negative_slope: float = 0.2):
    """GAT layer output on the band: y = sum_e Wx @ (S*alpha).
    Returns (B, P, F, N). Matches filters.graph_attention on banded S."""
    alpha_col, Wx = band_attention_coefficients(x, a, W_p, slab5, w,
                                                negative_slope)
    coeff = slab5[None, None] * alpha_col           # B,P,E,nb,W,ibs,ibs
    y = _band_aggregate(Wx, coeff, w)
    y = y.sum(dim=2)                                # sum over E
    n = x.shape[-1] if n_out is None else n_out
    return y[..., :n]


def gat_lsigf_band(h, x, a, W_p, slab5, w, b=None,
                   negative_slope: float = 0.2):
    """K-tap GCAT over banded attention coefficients (shift = alpha,
    reference graphML.py:876-879). h: (E,K) -> y: (B,P,F,N)."""
    E, K = h.shape
    P, _, F, G = W_p.shape
    B, _, N = x.shape
    alpha_col, _ = band_attention_coefficients(x, a, W_p, slab5, w,
                                               negative_slope)
    W_taps = W_p.permute(0, 3, 1, 2).reshape(P, F, E, 1, G)
    hW = h[None, None, :, :, None] * W_taps         # P,F,E,K,G
    xe = x[:, None, None].expand(B, P, E, G, N)
    zs = [xe]
    for _ in range(1, K):
        xe = _band_aggregate(xe, alpha_col, w)[..., :N]
        zs.append(xe)
    z = torch.stack(zs, dim=3)                      # B,P,E,K,G,N
    y = torch.einsum("bpekgn,pfekg->bpfn", z, hW)
    return y if b is None else y + b


def gat_evgf_band(x, a, W_p, slab5, w, b=None, negative_slope: float = 0.2):
    """Per-hop banded attention edge-variant filter (reference
    graphML.py:897-969). a: (P,K,E,2F), W_p: (P,K,E,F,G) -> (B,P,F,N)."""
    P, K, E, F, G = W_p.shape
    N = x.shape[-1]
    alpha0, _ = band_attention_coefficients(x, a[:, 0], W_p[:, 0], slab5, w,
                                            negative_slope)
    v = torch.einsum("pefg,bgn->bpefn", W_p[:, 0], x)
    v = _band_aggregate(v, slab5[None, None] * alpha0, w)[..., :N]
    y = v
    for k in range(1, K):
        alpha_k, _ = band_attention_coefficients(x, a[:, k], W_p[:, k],
                                                 slab5, w, negative_slope)
        v = _band_aggregate(v, slab5[None, None] * alpha_k, w)[..., :N]
        y = y + v
    y = y.sum(dim=2)
    return y if b is None else y + b
