"""Device choice and math precision for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means the GPU. A CUDA device without a GPU raises: the port
    never drops to the CPU on its own; callers that want the CPU say so."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "splatfields_torch runs on a CUDA GPU by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev


def full_f32_math():
    """Keep cuDNN convolutions and CUDA matmuls in f32: torch's defaults
    let cuDNN run convolutions in TF32, a 10-bit mantissa, and the port's
    numerics are the JAX package's f32. The CLIs call this before any
    work."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
