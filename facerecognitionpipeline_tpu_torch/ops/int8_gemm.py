"""The int8 product of the quantized layers: s8 x s8 -> s32, exact.

The JAX package computes its quantized convolutions and dense layers with
XLA (`lax.conv_general_dilated` and `lax.dot_general` with
`preferred_element_type=int32` in `models/irse.py::QuantConv, QuantDense`),
outside any Pallas kernel. The port does the same with a library product:

* im2col: the NHWC int8 input is zero-padded and one strided copy of its
  window view gives [M, kh*kw*C] int8 with K in the order of an HWIO
  kernel's rows. (`F.unfold` takes no int8 tensor.)
* the card route (CUDA tensors): `torch._int_mm`, cuBLASLt's int8 product,
  on that im2col and on the weight laid out once at load as [N_pad, K_pad]
  int8 (`pack_weight`) and passed transposed, i.e. column-major, the layout
  of the second operand that cuBLASLt's int8 kernels take (with a row-major
  one it refuses some row counts). `torch._int_mm` takes only M > 16,
  K % 8 == 0 and N % 8 == 0; rows and columns of zeros pad each, which
  leaves every sum exact. `int8_gemm_geometry` holds that arithmetic.
* the plain version (CPU tensors; on the card only when a caller passes
  `plain=True`): the same im2col and the product in float64, exact while
  |sum| < 2**53 (one 3x3x512 window reaches 4608 * 127**2, about 7.4e7).

A float32 conv over the int8 values would not be exact: its sums round
from 2**24 on. On a CUDA tensor a failure of the card route raises; it never
gives way to the plain version.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from facerecognitionpipeline_tpu_torch.ops import cuda_build

#: cuBLASLt's int8 product takes more than 16 rows.
MIN_ROWS = 17
#: ... and K and N in multiples of 8.
ALIGN = 8

#: `torch._int_mm` calls of the card route (never the plain version).
PRODUCTS = cuda_build.LaunchCounter()


def _ceil(v: int, a: int) -> int:
    return -(-v // a) * a


def int8_gemm_geometry(m: int, k: int, n: int) -> tuple[int, int, int]:
    """(M, K, N) of a product -> the padded (M, K, N) that cuBLASLt's int8
    product takes: M at least MIN_ROWS, K and N rounded up to ALIGN."""
    if min(m, k, n) < 1:
        raise ValueError(f"empty int8 product: m={m} k={k} n={n}")
    return max(m, MIN_ROWS), _ceil(k, ALIGN), _ceil(n, ALIGN)


def pack_weight(w_kn: torch.Tensor) -> torch.Tensor:
    """int8 weight [K, N] (an HWIO kernel reshaped, or a dense [in, out]) ->
    int8 [N_pad, K_pad], contiguous, zero padded. Made once, at load."""
    if w_kn.dtype != torch.int8 or w_kn.dim() != 2:
        raise TypeError(f"pack_weight takes int8 [K, N], got {w_kn.dtype} {tuple(w_kn.shape)}")
    k, n = w_kn.shape
    _, kp, np_ = int8_gemm_geometry(1, k, n)
    out = torch.zeros((np_, kp), dtype=torch.int8, device=w_kn.device)
    out[:n, :k] = w_kn.t()
    return out


def im2col(xq: torch.Tensor, ksize: tuple[int, int], stride: int, padding: int,
           k_pad: int) -> torch.Tensor:
    """xq [B, H, W, C] int8 -> [B*Ho*Wo, k_pad] int8: each output pixel's
    window, ordered (kh, kw, C) like an HWIO kernel's rows, with zero
    columns up to k_pad. One strided copy of a window view of the padded
    input; with C % 4 == 0 it moves the codes four to a 32-bit word."""
    b, h, w, c = xq.shape
    kh, kw = ksize
    ho = (h + 2 * padding - kh) // stride + 1
    wo = (w + 2 * padding - kw) // stride + 1
    if ho < 1 or wo < 1:
        raise ValueError(f"a {kh}x{kw} window does not fit a {h}x{w} input")
    k = kh * kw * c
    if k_pad < k:
        raise ValueError(f"k_pad {k_pad} < {k}")
    xp = F.pad(xq, (0, 0, padding, padding, padding, padding)) if padding else xq.contiguous()
    out = torch.empty((b, ho, wo, k_pad), dtype=torch.int8, device=xq.device)
    if k_pad > k:
        out[..., k:] = 0
    dst = out[..., :k]
    if c % 4 == 0 and k_pad == k:
        xp, dst, c = xp.view(torch.int32), out.view(torch.int32), c // 4
    sb, sh, sw, sc = xp.stride()
    win = xp.as_strided((b, ho, wo, kh, kw, c),
                        (sb, sh * stride, sw * stride, sh, sw, sc))
    dst.unflatten(-1, (kh, kw, c)).copy_(win)
    return out.reshape(b * ho * wo, k_pad)


def int8_product(a: torch.Tensor, w: torch.Tensor, n: int, plain: bool = False) -> torch.Tensor:
    """a [M, K_pad] int8 @ the packed weight w [N_pad, K_pad] int8 ->
    [M, n] int32, exact. The card route for CUDA tensors, the plain version
    for CPU tensors or when `plain` is asked for."""
    if a.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError("int8_product takes int8 operands")
    if a.shape[1] != w.shape[1] or not n <= w.shape[0]:
        raise ValueError(f"int8_product: a {tuple(a.shape)} and w {tuple(w.shape)} for n={n}")
    if a.device.type == "cpu" or plain:
        # float64 sums of int8 products are exact below 2**53
        return (a.double() @ w.double().t())[:, :n].to(torch.int32)
    if a.device.type != "cuda":
        raise ValueError(f"int8_product: unsupported device {a.device}")
    m = a.shape[0]
    mp, kp, np_ = int8_gemm_geometry(m, a.shape[1], w.shape[0])
    if (kp, np_) != (a.shape[1], w.shape[0]):
        raise ValueError(f"int8_product: a {tuple(a.shape)} / w {tuple(w.shape)} are not "
                         f"padded for cuBLASLt (pack_weight does it)")
    if mp > m:
        a = torch.cat([a, a.new_zeros((mp - m, a.shape[1]))])
    y = torch._int_mm(a.contiguous(), w.t())
    PRODUCTS.bump()
    return y[:m, :n]


def int8_conv2d(xq: torch.Tensor, w: torch.Tensor, ksize: tuple[int, int], stride: int,
                padding: int, n: int, plain: bool = False) -> torch.Tensor:
    """xq [B, H, W, C] int8 (NHWC) convolved with the packed kernel w
    [N_pad, K_pad] (`pack_weight` of the HWIO kernel reshaped to
    [kh*kw*C, n]) -> [B, Ho, Wo, n] int32, symmetric zero padding."""
    b = xq.shape[0]
    kh, kw = ksize
    ho = (xq.shape[1] + 2 * padding - kh) // stride + 1
    wo = (xq.shape[2] + 2 * padding - kw) // stride + 1
    a = im2col(xq, ksize, stride, padding, w.shape[1])
    return int8_product(a, w, n, plain=plain).reshape(b, ho, wo, n)


def int8_linear(xq: torch.Tensor, w: torch.Tensor, n: int, plain: bool = False) -> torch.Tensor:
    """xq [M, K] int8 @ the packed weight w [N_pad, K_pad] -> [M, n] int32."""
    m, k = xq.shape
    if w.shape[1] > k:
        xq = torch.cat([xq, xq.new_zeros((m, w.shape[1] - k))], dim=1)
    return int8_product(xq, w, n, plain=plain)
