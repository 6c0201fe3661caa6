"""Serving: a fixed-batch forward for ragged request batches.

The counterpart of the JAX package's ``serving.InferenceEngine``: one
batch size is fixed at construction, a request of fewer rows is
zero-padded up to it and the answer sliced back, and a larger request is
refused. The forward runs eagerly under ``torch.inference_mode()`` on the
architecture's device; outputs are f32.
"""

from __future__ import annotations

import torch

from graph_neural_networks_torch.utils.device import resolve_device

__all__ = ["InferenceEngine"]


class InferenceEngine:
    """Fixed-shape forward for serving one architecture.

    arch: a ported architecture (SelectionGNN, LocalGNN,
    GraphAttentionNetwork, GraphConvolutionAttentionNetwork,
    EdgeVariantAttention); it is moved to `device` with its parameters and
    structure tables. A band-mode attention model builds its band
    structure (``attention_flash.band_auxes``) at the first request and
    keeps it on the GSO.
    """

    def __init__(self, arch, batch_size: int, device="cuda"):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.device = resolve_device(device)
        self.arch = arch.to(self.device)
        self.batch_size = int(batch_size)

    def __call__(self, x) -> torch.Tensor:
        """Answer one request batch x (n, F0, N), n <= batch_size."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        n = x.shape[0]
        B = self.batch_size
        if n > B:
            raise ValueError(f"request batch {n} exceeds the engine's batch "
                             f"size {B}")
        if n < B:
            x = torch.cat([x, x.new_zeros((B - n,) + tuple(x.shape[1:]))])
        with torch.inference_mode():
            y = self.arch.apply(x)
        return y[:n].float()
