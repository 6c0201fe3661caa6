"""Graph filter functionals, lowered to the graph shift.

Conventions (as in the JAX package's ``ops/filters.py``):
  x : (B, G, N) graph signals, h : (F, E, K, G) taps, S : (E, N, N) GSO,
  y : (B, F, N). Shift = row-vector right-multiplication ``x @ S``.
"""

from __future__ import annotations

from typing import Optional

import torch

from graph_neural_networks_torch.ops import gso as gso_lib


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
