"""The shared arithmetic of the per-layer readers: a roofline share reads
every kernel it expects, or nothing."""

from __future__ import annotations

import pytest

from benchmark.lib import counts, readings
from benchmark.lib import spec as spec_mod
from benchmark.lib.runner import Context
from benchmark.tests.conftest import ROOT


class _Stages:
    def __init__(self, kernel_ms: dict):
        self._k = kernel_ms

    def kernel_ms(self) -> dict:
        return self._k


def _profile(cfg) -> dict:
    """Every expected kernel at twice its bound, under its profiler name,
    beside a library kernel the share does not count."""
    bounds = counts.kernel_bounds(cfg, int(cfg["batch_max"]))
    prof = {f"void {counts.KERNEL_NAMES[k][0]}<8>(float const*)": 2e3 * s
            for k, s in bounds.items()}
    prof["cutlass::Kernel2<int8_gemm>"] = 5.0
    return prof


@pytest.mark.parametrize("config", ["ir101_bf16_class1k", "ir101_int8_campus1m"])
def test_kernels_roofline_reads_every_expected_kernel(config):
    cfg = spec_mod.config(spec_mod.benchmark(ROOT), config, ROOT)
    prof = _profile(cfg)
    ctx = Context(cfg, {}, None, 0.0, stages=_Stages(prof))
    assert readings.kernels_roofline(ctx) == pytest.approx(50.0)
    expected = counts.kernel_bounds(cfg, int(cfg["batch_max"]))
    assert ("gallery_topk_int8" in expected) == (config == "ir101_int8_campus1m")
    for kernel in expected:  # one kernel gone from the profile: no reading
        name = next(n for n in prof if counts.KERNEL_NAMES[kernel][0] in n)
        missing = {n: v for n, v in prof.items() if n != name}
        ctx = Context(cfg, {}, None, 0.0, stages=_Stages(missing))
        assert readings.kernels_roofline(ctx) is None, kernel


def test_kernels_roofline_off_the_chip_reads_nothing():
    cfg = spec_mod.config(spec_mod.benchmark(ROOT), "ir101_bf16_class1k", ROOT)
    assert readings.kernels_roofline(Context(cfg, {}, None, 0.0)) is None
