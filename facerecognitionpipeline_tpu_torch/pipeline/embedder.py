"""FaceEmbedder: the IR backbone with its weights on the device.

Counterpart of `facerecognitionpipeline_tpu/pipeline/embedder.py` for the
serving configuration: BN folded into the weights (`fold_bn=True`), compute
in `dtype` (bf16 on the serving path). Weights come from a JAX-format
`.npz` (`model_path`), from JAX-format variables (`variables`), from a
converted state dict (`state_dict`), or from a seeded random init
(`init_seed`; `random_ok` silences the warning). `model_type` ('adaface' or
'arcface') names the weights' family; both families share the IR backbones
built here. The `.ckpt`/`.onnx` importers (with ArcFace's iresnet flavour)
and the int8 tier are queued in ROADMAP.md.

The float32 parameters are cast to the compute dtype once, on load; the JAX
package casts them on every call, which gives the same values.
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np
import torch

from facerecognitionpipeline_tpu_torch.models.convert import backbone_state_from_jax
from facerecognitionpipeline_tpu_torch.models.fold import fold_inference_variables
from facerecognitionpipeline_tpu_torch.models.irse import build_backbone
from facerecognitionpipeline_tpu_torch.models.layers import lecun_normal_
from facerecognitionpipeline_tpu_torch.ops.image import normalize_face_batch
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
        random_ok: bool = False,
        device="cuda",
    ):
        if model_type not in ("adaface", "arcface"):
            raise ValueError(
                f"Unknown model_type: {model_type}. Must be 'adaface' or 'arcface'"
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
        self.model = model.to(device=self.device, dtype=dtype).eval()

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
