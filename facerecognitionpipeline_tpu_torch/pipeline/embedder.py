"""FaceEmbedder: the IR backbone with its weights on the device.

Counterpart of `facerecognitionpipeline_tpu/pipeline/embedder.py`: BN folded
into the weights (`fold_bn=True`), compute in `dtype` (bf16 on the serving
path). Weights come from `model_path` -- an AdaFace Lightning `.ckpt` (or
any torch state-dict file, `models/torch_import.py`), an ArcFace `.onnx`
(`models/onnx_import.py`, which builds the iresnet flavour of ir_50/ir_101)
or a JAX-format `.npz` --, from the `ADAFACE_MODELS`/`ARCFACE_MODELS` table
when no path is given, from JAX-format variables (`variables`), from a
converted state dict (`state_dict`), or from a seeded random init
(`init_seed`; `random_ok` silences the warning). A given `model_path` that
does not exist raises FileNotFoundError. `quantize='int8'` is the JAX
package's post-training int8 tier: the two 3x3 res convs of every unit
become static-scale int8 convs, calibrated on `calib_faces`
(`models/quantize.py`); `int8_fused=True` runs each quantized unit's body as
one fused int8 chain (`irse.FusedQuantBody`, constants from
`quantize.fuse_quantized_params`).

The host API (`extract_embedding`, `extract_embeddings_batch`,
`compute_similarity`, `compute_similarity_batch`, `aggregate_embeddings`)
is the JAX package's: crops of any size are resized on the host with cv2
(INTER_LINEAR), embedded in chunks of 512 padded to power-of-two buckets
from 8 (so cuDNN meets a handful of shapes), and re-normalised with the
reference's eps.

The float32 parameters are cast to the compute dtype once, on load; the JAX
package casts them on every call, which gives the same values.
"""

from __future__ import annotations

import os
import sys
from typing import Optional, Sequence, Union

import numpy as np
import torch

from facerecognitionpipeline_tpu_torch.models.convert import (
    backbone_state_from_jax,
    params_from_state,
)
from facerecognitionpipeline_tpu_torch.models.fold import fold_inference_variables
from facerecognitionpipeline_tpu_torch.models.irse import build_backbone
from facerecognitionpipeline_tpu_torch.models.layers import lecun_normal_
from facerecognitionpipeline_tpu_torch.ops.image import (
    normalize_face_batch,
    preprocess_faces,
)
from facerecognitionpipeline_tpu_torch.utils.device import resolve_device
from facerecognitionpipeline_tpu_torch.utils.io import load_npz_variables

# Default pretrained-weight locations (the reference face_embedder.py:16-24
# convention, relative to the repo root).
_PRETRAINED_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "pretrained",
)
ADAFACE_MODELS = {
    "ir_50": os.path.join(_PRETRAINED_DIR, "adaface_ir50_ms1mv2.ckpt"),
    "ir_101": os.path.join(_PRETRAINED_DIR, "adaface_ir101_ms1mv3.ckpt"),
}
ARCFACE_MODELS = {
    "ir_50": os.path.join(_PRETRAINED_DIR, "arcface_ir50_ms1mv3.ckpt"),
    "ir_101": os.path.join(_PRETRAINED_DIR, "arcface_ir101_ms1mv3.ckpt"),
}

_EPS = 1e-8
_MAX_DEVICE_BATCH = 512


def _bucket(n: int) -> int:
    """Smallest power of two >= n (>= 8), so batch shapes repeat."""
    b = 8
    while b < n:
        b *= 2
    return min(b, _MAX_DEVICE_BATCH)


class FaceEmbedder:
    """IR/IR-SE embedding backbone on one device."""

    def __init__(
        self,
        architecture: str = "ir_101",
        model_path: Optional[str] = None,
        model_type: str = "adaface",
        dtype: torch.dtype = torch.float32,
        variables: Optional[dict] = None,
        state_dict: Optional[dict] = None,
        init_seed: int = 0,
        fold_bn: bool = True,
        quantize: Optional[str] = None,
        calib_faces: Optional[np.ndarray] = None,
        random_ok: bool = False,
        int8_fused: bool = False,
        device="cuda",
    ):
        """quantize: None or 'int8', the post-training int8 tier (needs
        fold_bn=True). calib_faces: the activation-scale calibration batch,
        raw RGB uint8 [N, H, W, 3] crops (resized to 112 if they are not);
        default `models/quantize.default_calibration_faces()`, 64 synthetic
        renders (use real aligned faces with imported real-world weights).
        int8_fused: with quantize='int8', each unit's residual body as one
        fused int8 chain (FusedQuantBody), the same algebra with fewer
        elementwise passes."""
        if model_type not in ("adaface", "arcface"):
            raise ValueError(
                f"Unknown model_type: {model_type}. Must be 'adaface' or 'arcface'"
            )
        if quantize not in (None, "int8"):
            raise ValueError(f"Unknown quantize mode: {quantize!r} (use 'int8')")
        if quantize and not fold_bn:
            raise ValueError("quantize='int8' requires fold_bn=True")
        self.device = resolve_device(device)
        self.model_type = model_type
        self.architecture = architecture
        self.input_size = (112, 112)
        self._dtype = dtype

        # resolve the weights path before building: ArcFace .onnx files carry
        # the iresnet flavour of the architecture (conv shortcuts on stride)
        resolved_path = model_path
        if variables is None and state_dict is None and resolved_path is None:
            table = ADAFACE_MODELS if model_type == "adaface" else ARCFACE_MODELS
            resolved_path = table.get(architecture)
        build_arch = architecture
        if model_type == "arcface" and resolved_path is not None and (
            resolved_path.endswith(".onnx")
        ):
            build_arch = {"ir_50": "iresnet_50", "ir_101": "iresnet_100"}.get(
                architecture, architecture
            )
        self._build_arch = build_arch
        if variables is None and state_dict is None and resolved_path is not None:
            if os.path.exists(resolved_path):
                variables = self._load_weights(resolved_path)
            elif model_path is not None:
                raise FileNotFoundError(f"Model weights not found at: {model_path}")
        self.pretrained = variables is not None or state_dict is not None

        if state_dict is not None:
            folded = "input_conv.bias" in state_dict
        elif variables is not None:
            if "batch_stats" in variables and fold_bn:
                variables = fold_inference_variables(variables)
            folded = "batch_stats" not in variables
            state_dict = backbone_state_from_jax(variables, folded=folded)
        else:
            if not random_ok:
                where = (
                    f"at {resolved_path}" if resolved_path is not None
                    else f"configured for architecture {architecture!r}"
                )
                print(
                    f"[FaceEmbedder] No pretrained weights {where}; using random "
                    f"init (embeddings will not be identity-discriminative).",
                    file=sys.stderr,
                )
            folded = fold_bn
        if folded and not fold_bn:
            raise ValueError("fold_bn=False but the given weights are folded")
        model = build_backbone(build_arch, folded=folded)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        else:
            lecun_normal_(model, torch.Generator().manual_seed(init_seed))
        self.folded = folded
        if quantize and not folded:
            raise ValueError("quantize='int8' needs folded weights (fold_bn=True)")
        # quantize the float32 weights, not the cast module's
        float_params = params_from_state(model.state_dict()) if quantize else None
        self.model = model.to(device=self.device, dtype=dtype).eval()

        self.quantized = False
        if quantize == "int8":
            self._quantize(float_params, calib_faces, int8_fused)

    def _quantize(self, float_params: dict, calib_faces, fused: bool) -> None:
        """Calibrate the float backbone, quantize its float32 weights and
        swap in the int8 backbone."""
        from facerecognitionpipeline_tpu_torch.models.quantize import (
            calibrate_activation_amax,
            default_calibration_faces,
            fuse_quantized_params,
            quantize_folded_variables,
        )

        if calib_faces is None:
            if self.pretrained:
                # scales calibrated on synthetic renders transfer only
                # approximately to real-world weights and faces
                print(
                    "[FaceEmbedder] quantize='int8' with pretrained "
                    "weights but no calib_faces: calibrating activation "
                    "scales on SYNTHETIC renders. Pass calib_faces (or "
                    "the server's --quantize_calib DIR) with real "
                    "aligned crops before trusting accuracy — see "
                    "docs/weights.md.",
                    file=sys.stderr,
                )
            calib_faces = default_calibration_faces()
        calib_faces = np.asarray(calib_faces)
        if calib_faces.ndim != 4 or calib_faces.shape[0] == 0 or (
            calib_faces.shape[-1] != 3
        ):
            raise ValueError(
                f"calib_faces must be [N>0, H, W, 3] RGB crops, got "
                f"shape {calib_faces.shape}"
            )
        faces = preprocess_faces(
            torch.as_tensor(calib_faces).to(self.device), dtype=self._dtype
        )
        amax = calibrate_activation_amax(self.model, faces)
        quantized = quantize_folded_variables({"params": float_params}, amax)
        if fused:
            quantized = fuse_quantized_params(quantized)
        model = build_backbone(self._build_arch, folded=True, quantized=True,
                               fused_int8=fused)
        model.load_state_dict(backbone_state_from_jax(quantized, folded=True))
        self.model = model.to(device=self.device, dtype=self._dtype).eval()
        self.quantized = True

    def _load_weights(self, path: str) -> dict:
        print(
            f"Loading {self.model_type} weights ({self.architecture}) from {path}...",
            file=sys.stderr,
        )
        if path.endswith(".npz"):
            return load_npz_variables(path)
        if path.endswith(".onnx"):
            from facerecognitionpipeline_tpu_torch.models.onnx_import import (
                load_arcface_onnx,
            )

            return load_arcface_onnx(path, self._build_arch)
        from facerecognitionpipeline_tpu_torch.models.torch_import import (
            load_adaface_checkpoint,
        )

        return load_adaface_checkpoint(path, self.architecture)

    def forward(self, faces: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Normalized BGR faces [B,112,112,3] -> (features [B,512] float32,
        norms [B,1] float32)."""
        with torch.inference_mode():
            return self.model(faces)

    def embed_batch_device(self, faces_rgb: torch.Tensor):
        """Raw RGB faces [B,112,112,3] on the device -> (features, norms)."""
        if tuple(faces_rgb.shape[1:3]) != self.input_size:
            raise ValueError(
                f"faces must be {self.input_size}, got {tuple(faces_rgb.shape[1:3])}"
            )
        return self.forward(normalize_face_batch(faces_rgb, dtype=self._dtype))

    def extract_embedding(self, face_image: np.ndarray, normalize: bool = True) -> np.ndarray:
        """One RGB face [H,W,3] -> [512] float32."""
        return self.extract_embeddings_batch([face_image], normalize=normalize)[0]

    def extract_embeddings_batch(
        self,
        face_images: Union[Sequence[np.ndarray], np.ndarray],
        normalize: bool = True,
        batch_size: Optional[int] = None,  # kept for API compatibility
    ) -> np.ndarray:
        """RGB faces (a list of [H,W,3] arrays of any size, or one [N,H,W,3]
        array) -> [N, 512] float32. Crops not 112x112 are resized on the host;
        chunks of 512 are padded to a power-of-two bucket and the padding is
        sliced off."""
        if len(face_images) == 0:
            return np.zeros((0, 512), np.float32)
        if isinstance(face_images, np.ndarray) and face_images.ndim == 4:
            arrs = face_images.astype(np.float32)
            if arrs.shape[1:3] != self.input_size:
                arrs = np.stack([self._resize_host(f) for f in arrs])
        else:
            arrs = np.stack([self._resize_host(np.asarray(f)) for f in face_images])

        outs = []
        for start in range(0, arrs.shape[0], _MAX_DEVICE_BATCH):
            chunk = arrs[start:start + _MAX_DEVICE_BATCH]
            padded = np.zeros((_bucket(chunk.shape[0]), *chunk.shape[1:]), np.float32)
            padded[: chunk.shape[0]] = chunk
            feat, _ = self.embed_batch_device(torch.from_numpy(padded).to(self.device))
            outs.append(feat[: chunk.shape[0]].float().cpu().numpy())
        emb = np.concatenate(outs, axis=0)
        if normalize:
            # the backbone's output is already unit-norm; the reference's
            # eps normalisation keeps downstream math identical
            emb = emb / (np.linalg.norm(emb, axis=1, keepdims=True) + _EPS)
        return emb

    def _resize_host(self, face: np.ndarray) -> np.ndarray:
        import cv2

        face = face.astype(np.float32)
        if face.shape[:2] != self.input_size:
            face = cv2.resize(face, self.input_size, interpolation=cv2.INTER_LINEAR)
        return face

    # ----------------------------------------------------- similarity utils

    @staticmethod
    def compute_similarity(embedding1: np.ndarray, embedding2: np.ndarray) -> float:
        """Cosine similarity with the reference's eps semantics."""
        e1 = embedding1 / (np.linalg.norm(embedding1) + _EPS)
        e2 = embedding2 / (np.linalg.norm(embedding2) + _EPS)
        return float(np.dot(e1, e2))

    @staticmethod
    def compute_similarity_batch(
        embedding: np.ndarray, gallery_embeddings: np.ndarray
    ) -> np.ndarray:
        """One query against a [G,512] gallery -> [G] cosines."""
        q = embedding / (np.linalg.norm(embedding) + _EPS)
        norms = np.linalg.norm(gallery_embeddings, axis=1, keepdims=True)
        g = gallery_embeddings / (norms + _EPS)
        return np.dot(g, q)

    @staticmethod
    def aggregate_embeddings(embeddings: np.ndarray, method: str = "mean") -> np.ndarray:
        """mean / median / weighted_mean template aggregation."""
        embeddings = np.asarray(embeddings)
        if len(embeddings) == 0:
            raise ValueError("Cannot aggregate empty embeddings")
        if len(embeddings) == 1:
            return embeddings[0]
        if method == "mean":
            agg = np.mean(embeddings, axis=0)
        elif method == "median":
            agg = np.median(embeddings, axis=0)
        elif method == "weighted_mean":
            sims = np.dot(embeddings, embeddings.T)
            weights = np.mean(sims, axis=1)
            weights = weights / np.sum(weights)
            agg = np.sum(embeddings * weights[:, None], axis=0)
        else:
            raise ValueError(f"Unknown aggregation method: {method}")
        return agg / (np.linalg.norm(agg) + _EPS)
