"""FaceEmbedder: the IR backbone with its weights on the device.

Counterpart of `facerecognitionpipeline_tpu/pipeline/embedder.py` for the
serving configuration: BN folded into the weights (`fold_bn=True`), compute
in `dtype` (bf16 on the serving path). Weights come from a JAX-format
`.npz` (`model_path`), from JAX-format variables (`variables`), from a
converted state dict (`state_dict`), or from a seeded random init
(`init_seed`; `random_ok` silences the warning). `model_type` ('adaface' or
'arcface') names the weights' family; both families share the IR backbones
built here. `quantize='int8'` is the JAX package's post-training int8 tier:
the two 3x3 res convs of every unit become static-scale int8 convs,
calibrated on `calib_faces` (`models/quantize.py`). The `.ckpt`/`.onnx`
importers (with ArcFace's iresnet flavour) and the fused int8 body
(`int8_fused`) are queued in ROADMAP.md.

The float32 parameters are cast to the compute dtype once, on load; the JAX
package casts them on every call, which gives the same values.
"""

from __future__ import annotations

import sys
from typing import Optional

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
        int8_fused: the fused int8 body is not ported (NotImplementedError)."""
        if model_type not in ("adaface", "arcface"):
            raise ValueError(
                f"Unknown model_type: {model_type}. Must be 'adaface' or 'arcface'"
            )
        if quantize not in (None, "int8"):
            raise ValueError(f"Unknown quantize mode: {quantize!r} (use 'int8')")
        if quantize and not fold_bn:
            raise ValueError("quantize='int8' requires fold_bn=True")
        if int8_fused:
            raise NotImplementedError(
                "int8_fused: the fused int8 body (FusedQuantBody) is queued in "
                "ROADMAP.md (int8 tier, item 16 with Int8FwdConv)"
            )
        self.device = resolve_device(device)
        self.model_type = model_type
        self.architecture = architecture
        self.input_size = (112, 112)
        self._dtype = dtype
        if model_path is not None:
            if not model_path.endswith(".npz"):
                raise NotImplementedError(
                    f"{model_path}: only JAX-format .npz weights load in the "
                    f"port; the .ckpt/.onnx importers are queued in ROADMAP.md"
                )
            variables = load_npz_variables(model_path)
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
                print(
                    "[FaceEmbedder] No weights given; using random init "
                    "(embeddings will not be identity-discriminative).",
                    file=sys.stderr,
                )
            folded = fold_bn
        if folded and not fold_bn:
            raise ValueError("fold_bn=False but the given weights are folded")
        model = build_backbone(architecture, folded=folded)
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
            self._quantize(float_params, calib_faces)

    def _quantize(self, float_params: dict, calib_faces) -> None:
        """Calibrate the float backbone, quantize its float32 weights and
        swap in the int8 backbone."""
        from facerecognitionpipeline_tpu_torch.models.quantize import (
            calibrate_activation_amax,
            default_calibration_faces,
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
        model = build_backbone(self.architecture, folded=True, quantized=True)
        model.load_state_dict(backbone_state_from_jax(quantized, folded=True))
        self.model = model.to(device=self.device, dtype=self._dtype).eval()
        self.quantized = True

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

    def extract_embeddings_batch(self, faces_rgb: np.ndarray) -> np.ndarray:
        """[N,112,112,3] RGB -> [N,512] float32 unit-norm embeddings."""
        x = torch.as_tensor(np.asarray(faces_rgb, np.float32), device=self.device)
        feats, _ = self.embed_batch_device(x)
        return feats.cpu().numpy()
