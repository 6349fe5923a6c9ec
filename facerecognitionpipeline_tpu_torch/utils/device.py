"""Device resolution for the port's entry points."""

from __future__ import annotations

import subprocess
from typing import Optional

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


def card_line(device="cuda") -> Optional[str]:
    """The card's name and power limit, `nvidia-smi --query-gpu=name,
    power.limit`'s first line; None for a CPU device or where nvidia-smi
    does not answer."""
    if torch.device(device).type != "cuda":
        return None
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = smi.stdout.strip().splitlines()
    return lines[0] if smi.returncode == 0 and lines else None
