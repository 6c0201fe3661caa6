"""Loss functions, the port of the JAX package's ``training/losses.py``
(itself mirroring ``alegnn/modules/loss.py``).

All losses take (estimate, target) tensors and return a scalar tensor.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn


def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Softmax cross entropy with integer labels; logits (B, C)."""
    return nn.functional.cross_entropy(logits, labels.long())


def mse_loss(estimate: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((estimate - target) ** 2)


def l1_loss(estimate: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(estimate - target))


def smooth_l1_loss(estimate: torch.Tensor, target: torch.Tensor,
                   beta: float = 1.0) -> torch.Tensor:
    """Huber-style smooth L1 (torch.nn.SmoothL1Loss semantics)."""
    d = torch.abs(estimate - target)
    return torch.mean(torch.where(d < beta, 0.5 * d ** 2 / beta,
                                  d - 0.5 * beta))


def adapt_extra_dimension_loss(loss_fn: Callable) -> Callable:
    """Squeeze the GNN's trailing singleton feature dim for scalar losses
    (reference loss.py:23-91: CrossEntropy keeps (B, C); MSE/L1/SmoothL1
    squeeze (B, 1) -> (B))."""
    def wrapped(estimate, target):
        if loss_fn is not cross_entropy_loss and estimate.ndim == 2 \
                and estimate.shape[1] == 1 and target.ndim == 1:
            estimate = estimate[:, 0]
        return loss_fn(estimate, target)
    return wrapped


def f1_score_loss(yHat: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Differentiable 1 - F1 on the infected class from 2-class logits
    (..., 2, N); NaN-guarded like the reference (loss.py:93-125)."""
    C = yHat.shape[-2]
    N = yHat.shape[-1]
    yHat = yHat.reshape(-1, C, N)
    prob1 = torch.softmax(yHat, dim=1)[:, 1, :]        # soft infected prob
    y = y.reshape(-1, N).to(prob1.dtype)
    tp = torch.sum(y * prob1, dim=1)
    fp = torch.sum((1 - y) * prob1, dim=1)
    fn = torch.sum(y * (1 - prob1), dim=1)
    eps = 1e-12
    one, zero = prob1.new_ones(()), prob1.new_zeros(())
    p_raw = tp / torch.clamp(tp + fp, min=eps)
    r_raw = tp / torch.clamp(tp + fn, min=eps)
    # reference NaN semantics: undefined precision/recall with tp==0 -> 1
    p = torch.where(tp + fp < eps, torch.where(tp < eps, one, zero), p_raw)
    r = torch.where(tp + fn < eps, torch.where(tp < eps, one, zero), r_raw)
    f1 = torch.where(p + r < eps, zero,
                     2 * p * r / torch.clamp(p + r, min=eps))
    return 1 - torch.mean(f1)
