"""Device resolution for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """`device` (str or torch.device) -> torch.device, raising when CUDA is
    asked for and absent. There is no silent CPU fallback: CPU runs must
    say `device="cpu"`.

    On CUDA this also pins the float32 precision the port is specified
    with: no TF32 in matmuls or cuDNN convolutions (PyTorch enables TF32
    for cuDNN by default). The serving path computes in bf16, so this only
    affects float32 configurations and the kernels' plain versions."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
