"""On the card: each cell runs briefly and comes out correct. Skips
without a card (the `card` fixture decides)."""

from __future__ import annotations

import time

import pytest

from benchmark.lib import spec as spec_mod
from benchmark.tests.conftest import ROOT

CELLS = [w["name"] for w in spec_mod.benchmark(ROOT)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct_on_the_card(card, workload):
    from benchmark.lib import runner

    rc, res = runner.run(workload, 2**31 + 17, 3.0, False, time.perf_counter())
    assert rc == 0 and res["correct"], res and res["checks"]
    assert res["device"]["platform"] == "gpu" and res["metrics"]["setup_s"]["value"] > 0
