"""Device resolution for the port's entry points."""

from __future__ import annotations

import subprocess
from typing import Callable, List, Optional

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


def card_fields(device="cuda") -> dict:
    """`card_line` as {"card": name, "power_limit": limit}, both None on the
    CPU."""
    line = card_line(device)
    if line is None:
        return {"card": None, "power_limit": None}
    name, _, limit = line.rpartition(",")
    return {"card": name.strip(), "power_limit": limit.strip()}


def chained_ms(fn: Callable, samples: int, chain: int, warm: int, device="cuda") -> List[float]:
    """Milliseconds per call of `fn`, one figure per window of `chain`
    chained calls, `samples` windows after `warm` calls: CUDA events on the
    current stream (nothing synchronises inside a window), or the host clock
    on the CPU."""
    import time

    for _ in range(warm):
        fn()
    if torch.device(device).type != "cuda":
        times = []
        for _ in range(samples):
            t0 = time.perf_counter()
            for _ in range(chain):
                fn()
            times.append((time.perf_counter() - t0) * 1e3 / chain)
        return times
    torch.cuda.synchronize(device)
    events = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(chain):
            fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize(device)
    return [a.elapsed_time(b) / chain for a, b in events]


def profiled_device_ms(fn: Callable, calls: int = 3, device="cuda") -> Optional[float]:
    """Device milliseconds per call of `fn`, summed over every CUDA kernel
    torch.profiler sees in `calls` calls; None on the CPU or where the
    profiler sees no device time."""
    if torch.device(device).type != "cuda":
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize(device)
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / calls / 1e3 if us > 0 else None
