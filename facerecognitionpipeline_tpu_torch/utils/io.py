"""Host-side image IO (RGB numpy in and out) and weight archives.

Counterpart of `facerecognitionpipeline_tpu/utils/io.py`. All disk and codec
work stays on the host, off the device step. The codec is `cv2`, imported at
the call that needs it and never when this module is imported, so the server
and the models import without it.

Weight archives are the JAX package's native `.npz`: a plain-array archive
whose keys are '/'-joined variable paths (e.g. 'pnet/params/conv1/kernel'),
unflattened into nested dicts of numpy arrays without flax;
`models/convert.py` maps those to torch state dicts.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

VALID_EXTENSIONS = {".jpg", ".jpeg", ".png", ".bmp"}


def decode_image_rgb(raw: bytes) -> Optional[np.ndarray]:
    """Encoded image bytes (PNG, JPEG, ...) -> RGB uint8 [H,W,3]; None when
    the bytes are not a decodable image."""
    import cv2

    if not raw:
        return None
    img = cv2.imdecode(np.frombuffer(raw, np.uint8), cv2.IMREAD_COLOR)
    if img is None:
        return None
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def encode_image_rgb(image_rgb: np.ndarray, image_format: str = "png") -> bytes:
    """RGB array -> PNG bytes (compression 3) or, with image_format='jpeg',
    JPEG bytes at quality 92."""
    import cv2

    arr = np.clip(np.asarray(image_rgb), 0, 255).astype(np.uint8)
    if image_format == "jpeg":
        ext, params = ".jpg", [cv2.IMWRITE_JPEG_QUALITY, 92]
    else:
        ext, params = ".png", [cv2.IMWRITE_PNG_COMPRESSION, 3]
    ok, buf = cv2.imencode(ext, cv2.cvtColor(arr, cv2.COLOR_RGB2BGR), params)
    return buf.tobytes() if ok else b""


def imread_rgb(path: str) -> Optional[np.ndarray]:
    """Read an image file as RGB uint8 [H,W,3]; None when unreadable."""
    import cv2

    img = cv2.imread(path)
    if img is None:
        return None
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def imwrite_rgb(path: str, image_rgb) -> None:
    """Write an RGB (float or uint8) array to disk. `image_rgb` may be a lazy
    device view (anything `np.asarray` takes): it is fetched here."""
    import cv2

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arr = np.clip(np.asarray(image_rgb), 0, 255).astype(np.uint8)
    cv2.imwrite(path, cv2.cvtColor(arr, cv2.COLOR_RGB2BGR))


def list_images(directory: str) -> list[str]:
    """Sorted image paths directly under `directory`."""
    if not os.path.isdir(directory):
        return []
    return [
        os.path.join(directory, f)
        for f in sorted(os.listdir(directory))
        if os.path.splitext(f)[1].lower() in VALID_EXTENSIONS
    ]


# ------------------------------------------------------------- weight npz


def flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    """{'a': {'b': {'c': x}}} -> {'a/b/c': x}."""
    flat: dict = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            flat.update(flatten(value, f"{path}/"))
        else:
            flat[path] = value
    return flat


def save_npz_variables(path: str, variables: dict) -> None:
    """Nested dict of arrays -> a flattened plain-array `.npz` ('/'-joined
    key paths, no pickled objects), the archive `load_npz_variables` and the
    JAX package's loader read. Written through a file handle: np.savez(str)
    appends '.npz' to a path without that suffix."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        np.savez(f, **{k: np.asarray(v) for k, v in flatten(variables).items()})


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
