"""ArcFace ONNX weight import without the `onnx` package.

Counterpart of `facerecognitionpipeline_tpu/models/onnx_import.py`, with the
same names and the same JAX-format variables out. The reference serves
ArcFace from insightface ONNX files (`face_embedder.py:64-88`). No `onnx` or
`onnxruntime` is used: this module reads the ONNX protobuf wire format
directly (a ~hundred-line subset: ModelProto.graph.initializer TensorProtos)
and maps insightface/arcface_torch **iresnet** statedict naming onto the IR
backbone's variables (the `iresnet_*` configurations).

The iresnet block (bn1 -> conv1 -> bn2 -> prelu -> conv2(stride) -> bn3, with
a conv1x1+bn downsample shortcut) is structurally identical to our
BasicBlockIR; the output head differs only in the final feature BatchNorm1d
being affine (gamma frozen to 1 in insightface training) with eps 2e-5 — we
fold the affine + eps difference exactly into the running statistics.

Requires the export to preserve parameter names as initializer names (true
for the standard arcface_torch -> onnx export path); raises with the found
names otherwise.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, Tuple

import numpy as np

from facerecognitionpipeline_tpu_torch.models.irse import BACKBONE_CONFIGS

# ---------------------------------------------------------------- protobuf

_WIRE_VARINT = 0
_WIRE_I64 = 1
_WIRE_LEN = 2
_WIRE_I32 = 5

# TensorProto.DataType -> numpy
_ONNX_DTYPES = {
    1: np.float32,
    2: np.uint8,
    3: np.int8,
    6: np.int32,
    7: np.int64,
    10: np.float16,
    11: np.float64,
}


def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def iter_fields(data: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) over one message's bytes."""
    pos = 0
    n = len(data)
    while pos < n:
        key, pos = _read_varint(data, pos)
        field, wire = key >> 3, key & 0x7
        if wire == _WIRE_VARINT:
            value, pos = _read_varint(data, pos)
        elif wire == _WIRE_I64:
            value = struct.unpack_from("<q", data, pos)[0]
            pos += 8
        elif wire == _WIRE_LEN:
            length, pos = _read_varint(data, pos)
            value = data[pos : pos + length]
            pos += length
        elif wire == _WIRE_I32:
            value = struct.unpack_from("<i", data, pos)[0]
            pos += 4
        else:
            raise ValueError(f"Unsupported protobuf wire type {wire}")
        yield field, wire, value


def _parse_tensor(data: bytes) -> Tuple[str, np.ndarray]:
    """TensorProto: 1=dims 2=data_type 4=float_data 8=name 9=raw_data."""
    dims, dtype_code, name = [], 1, ""
    raw = None
    floats = []
    for field, wire, value in iter_fields(data):
        if field == 1:
            if wire == _WIRE_LEN:  # packed dims
                pos = 0
                while pos < len(value):
                    d, pos = _read_varint(value, pos)
                    dims.append(d)
            else:
                dims.append(value)
        elif field == 2:
            dtype_code = value
        elif field == 4:
            if wire == _WIRE_LEN:  # packed floats
                floats.extend(
                    struct.unpack(f"<{len(value) // 4}f", value)
                )
            else:
                floats.append(struct.unpack("<f", struct.pack("<i", value))[0])
        elif field == 8:
            name = value.decode("utf-8")
        elif field == 9:
            raw = value
    dtype = _ONNX_DTYPES.get(dtype_code)
    if dtype is None:
        raise ValueError(f"Unsupported ONNX tensor dtype {dtype_code} for {name}")
    if raw is not None:
        arr = np.frombuffer(raw, dtype=dtype).reshape(dims)
    else:
        arr = np.asarray(floats, dtype=np.float32).reshape(dims)
    return name, arr.astype(np.float32)


def load_onnx_initializers(path: str) -> Dict[str, np.ndarray]:
    """ONNX file -> {initializer name: float32 array}."""
    with open(path, "rb") as f:
        model = f.read()
    graph = None
    for field, wire, value in iter_fields(model):
        if field == 7 and wire == _WIRE_LEN:  # ModelProto.graph
            graph = value
            break
    if graph is None:
        raise ValueError(f"{path}: no graph found (not an ONNX ModelProto?)")
    out = {}
    for field, wire, value in iter_fields(graph):
        if field == 5 and wire == _WIRE_LEN:  # GraphProto.initializer
            name, arr = _parse_tensor(value)
            out[name] = arr
    return out


# ----------------------------------------------------------------- mapping

_STAGE_CHANNELS = (64, 128, 256, 512)


def _conv(sd, key):
    return {"kernel": sd[f"{key}.weight"].transpose(2, 3, 1, 0)}


def _bn(sd, key):
    return (
        {"scale": sd[f"{key}.weight"], "bias": sd[f"{key}.bias"]},
        {"mean": sd[f"{key}.running_mean"], "var": sd[f"{key}.running_var"]},
    )


def convert_iresnet_weights(
    sd: Dict[str, np.ndarray], architecture: str, features_eps: float = 2e-5
) -> dict:
    """iresnet-named weights (from ONNX initializers or a torch statedict)
    -> IR backbone variables. The affine `features` BatchNorm1d folds exactly
    into the affine-less output_feature_bn (eps difference included)."""
    cfg = BACKBONE_CONFIGS[architecture]
    params: dict = {}
    stats: dict = {}

    params["input_conv"] = _conv(sd, "conv1")
    params["input_bn"], stats["input_bn"] = _bn(sd, "bn1")
    params["input_prelu"] = {"alpha": sd["prelu.weight"]}

    in_ch = 64
    for stage, (n_units, depth) in enumerate(zip(cfg["units"], _STAGE_CHANNELS)):
        for unit in range(n_units):
            base = f"layer{stage + 1}.{unit}"
            name = f"stage{stage}_unit{unit}"
            bp: dict = {}
            bs: dict = {}
            if in_ch != depth or f"{base}.downsample.0.weight" in sd:
                bp["shortcut_conv"] = _conv(sd, f"{base}.downsample.0")
                bp["shortcut_bn"], bs["shortcut_bn"] = _bn(sd, f"{base}.downsample.1")
            bp["res_bn1"], bs["res_bn1"] = _bn(sd, f"{base}.bn1")
            bp["res_conv1"] = _conv(sd, f"{base}.conv1")
            bp["res_bn2"], bs["res_bn2"] = _bn(sd, f"{base}.bn2")
            bp["res_prelu"] = {"alpha": sd[f"{base}.prelu.weight"]}
            bp["res_conv2"] = _conv(sd, f"{base}.conv2")
            bp["res_bn3"], bs["res_bn3"] = _bn(sd, f"{base}.bn3")
            params[name], stats[name] = bp, bs
            in_ch = depth

    params["output_bn"], stats["output_bn"] = _bn(sd, "bn2")
    params["output_fc"] = {"kernel": sd["fc.weight"].T, "bias": sd["fc.bias"]}

    # fold features (affine BN1d, eps 2e-5) into our affine-less BN (eps 1e-5):
    #   gamma*(z-mean)/sqrt(var+eps_i)+beta == (z-mean')/sqrt(var'+eps_o)
    gamma = sd["features.weight"]
    beta = sd["features.bias"]
    mean = sd["features.running_mean"]
    var = sd["features.running_var"]
    if np.any(np.abs(gamma) < 1e-12):
        raise ValueError("features BN gamma contains zeros; cannot fold")
    scale = np.sqrt(var + features_eps) / gamma
    our_eps = 1e-5
    stats["output_feature_bn"] = {
        "mean": mean - beta * scale,
        "var": scale ** 2 - our_eps,
    }
    return {"params": params, "batch_stats": stats}


def load_arcface_onnx(path: str, architecture: str) -> dict:
    """ONNX ArcFace model file -> IR backbone variables (JAX format)."""
    init = load_onnx_initializers(path)
    if "conv1.weight" not in init:
        names = sorted(init)[:10]
        raise ValueError(
            "ONNX initializers are not torch-named (expected 'conv1.weight' "
            f"etc.); found e.g. {names}. Re-export with preserved parameter "
            "names or convert via a torch statedict."
        )
    return convert_iresnet_weights(init, architecture)
