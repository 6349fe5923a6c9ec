"""Nothing under benchmark/ imports JAX or the JAX package, and the
reference imports nothing of the port; top-level names compared whole."""

from __future__ import annotations

import ast
import os

from benchmark.tests.conftest import ROOT

BENCH = os.path.join(ROOT, "benchmark")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "facerecognitionpipeline_tpu"}
PORT = "facerecognitionpipeline_tpu_torch"


def _imports(path: str) -> set:
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module.split(".")[0])
    return out


def _sources(top: str):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere():
    for path in _sources(BENCH):
        assert not _imports(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_port():
    for path in _sources(os.path.join(BENCH, "reference")):
        assert PORT not in _imports(path), path


def test_the_port_name_is_not_mistaken_for_the_jax_package():
    assert PORT.split(".")[0] not in FORBIDDEN


def test_run_refuses_a_process_that_holds_jax(monkeypatch):
    import sys
    import types

    from benchmark.lib import runner

    monkeypatch.setitem(sys.modules, "flax.linen", types.ModuleType("flax.linen"))
    assert "flax.linen" in runner.forbidden_modules()
    monkeypatch.setitem(sys.modules, "facerecognitionpipeline_tpu_torch_x",
                        types.ModuleType("facerecognitionpipeline_tpu_torch_x"))
    assert "facerecognitionpipeline_tpu_torch_x" not in runner.forbidden_modules()
