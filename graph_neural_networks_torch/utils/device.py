"""Device selection for the package's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; ``"cuda"`` unless told otherwise.

    There is no silent CPU path: asking for CUDA on a machine without it
    raises, and a caller that wants the CPU passes ``device="cpu"``. On
    CUDA this also turns TF32 off for matmuls and cuDNN, because the port
    is held to the JAX package's true-f32 numbers (its ``Gso.precision``
    defaults to 'highest'): the lsigf contraction and the MLP readout go
    through ``torch.matmul``. It also turns off cuBLAS's reduced-precision
    reductions of bf16 products, so a bf16 GEMM accumulates in f32 as the
    JAX package's bf16 dots do.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available on this machine; pass device='cpu' "
                "to run the plain PyTorch path on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev
