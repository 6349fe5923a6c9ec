"""The comparison that decides `correct` fails what it must: the control
(one precision below the configuration's) and answers broken where they
are produced, each driving the rest of a run on the CPU at a tiny size."""

from __future__ import annotations

import pytest

from benchmark.tests.conftest import run_tiny


def test_control_of_a_float_configuration_fails(tiny_root):
    """The program's own int8 path in place of its float one."""
    rc, sound = run_tiny(tiny_root, "tiny_open")
    rc2, ctl = run_tiny(tiny_root, "tiny_open", control=True)
    assert rc == rc2 == 0 and sound["correct"] and not ctl["correct"]
    assert ctl["checks"]["embed_gap"]["value"] > 10 * sound["checks"]["embed_gap"]["value"]


def test_control_of_an_int8_configuration_fails(tiny_root):
    """The reference with int4 codes in the program's place."""
    rc, sound = run_tiny(tiny_root, "tiny_closed")
    rc2, ctl = run_tiny(tiny_root, "tiny_closed", control=True)
    assert rc == rc2 == 0 and sound["correct"] and not ctl["correct"]
    assert ctl["checks"]["embed_gap"]["value"] > 1e-2


@pytest.mark.parametrize("fault", ["embedding", "match", "crop", "gate", "boxes", "landmarks",
                                   "half_batch"])
def test_an_answer_altered_where_it_is_produced_fails(tiny_root, fault):
    # three closed-loop streams keep batches of two, so half a batch is one
    # frame; twelve answers judged
    rc, res = run_tiny(tiny_root, "tiny_closed", seconds=2.0, sample=12, fault=fault)
    assert rc == 0 and not res["correct"], res["checks"]
