"""Weight archives in the JAX package's native `.npz` format.

Counterpart of `facerecognitionpipeline_tpu/utils/io.py::load_npz_variables`:
a plain-array `.npz` whose keys are '/'-joined variable paths
(e.g. 'pnet/params/conv1/kernel'). Unflattened into nested dicts of numpy
arrays without flax; `models/convert.py` maps those to torch state dicts.
"""

from __future__ import annotations

import numpy as np


def unflatten(flat: dict[str, np.ndarray]) -> dict:
    """{'a/b/c': x} -> {'a': {'b': {'c': x}}}."""
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def load_npz_variables(path: str) -> dict:
    """Nested dict of numpy arrays from a '/'-keyed `.npz`. allow_pickle is
    off: plain-array archives only, never pickled code from a weights path."""
    with np.load(path, allow_pickle=False) as blob:
        return unflatten({k: blob[k] for k in blob.files})
