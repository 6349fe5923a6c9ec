"""Rounding helpers shared by the port's resamplers.

Correctly rounded division by a constant, on every device.

PyTorch's CUDA kernels divide by a Python scalar as `x * (1/s)`, and
`s / x` runs as `reciprocal(x) * s` on every device; both can differ from
the correctly rounded quotient in the last bit. Sample positions and hat
weights must come out bit-identical to the JAX package's (and to the CUDA
kernels', which use `__fdiv_rn`), so the port divides by a 0-dim tensor
instead, which takes the elementwise IEEE division path.
"""

from __future__ import annotations

import torch


def div(x: torch.Tensor, s: float) -> torch.Tensor:
    """x / s, correctly rounded."""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


def rdiv(s: float, x: torch.Tensor) -> torch.Tensor:
    """s / x, correctly rounded."""
    return torch.full((), s, dtype=x.dtype, device=x.device) / x


def device_constant(values, device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A small constant vector [len(values)] made on `device` by one fill
    per value: no copy from host memory, so on a CUDA device it neither
    synchronises with the host nor breaks a CUDA graph capture (a captured
    copy from pageable host memory is refused). Each value rounds to
    `dtype` as `torch.tensor(values, dtype=dtype)` rounds it."""
    out = torch.empty(len(values), dtype=dtype, device=device)
    for i, v in enumerate(values):
        out[i].fill_(v)
    return out


def round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """float32 tensor holding `x` rounded to `dtype` (RNE)."""
    return x if dtype == torch.float32 else x.to(dtype).float()
