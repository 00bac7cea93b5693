"""Device resolution for the port's entry points.

Entry points (``create_deeplab``, ``InferenceServer``, ``cli/serve.main``)
run on the CUDA device unless the caller asks for the CPU explicitly. With no
GPU and no explicit request they raise instead of carrying on on the CPU.
"""

from __future__ import annotations

import torch


def set_float32_numerics() -> None:
    """The one place that sets the card's float32 math mode.

    Both flags are False: float32 convolutions (cuDNN) and matmuls run in full
    float32, not TF32, so parity with the reference is about the algorithm.
    TF32 / bf16 speed is a separate, measured choice.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device (raises without one); anything
    else -> ``torch.device(device)``, checked to exist."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU explicitly")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        set_float32_numerics()
    return dev
