"""Device-side gallery search: one matmul + top-k.

Counterpart of the dense path of `facerecognitionpipeline_tpu/gallery/search.py`.
The streaming kernels (K3/K4, `ops/pallas_gallery.py` in the JAX package)
and the sharded searches are queued in ROADMAP.md.
"""

from __future__ import annotations

import numpy as np
import torch

from facerecognitionpipeline_tpu_torch.ops.nms import top_k
from facerecognitionpipeline_tpu_torch.utils.device import resolve_device

_EPS = 1e-8
_NEG = -1e9


def template_rows(templates) -> int:
    """Row count of a template operand ([G, D], or the first of a pair)."""
    t = templates[0] if isinstance(templates, tuple) else templates
    return t.shape[0]


def cosine_topk(
    queries: torch.Tensor,
    templates: torch.Tensor,
    valid: torch.Tensor,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """queries [Q,D] (normalized here, +1e-8 on the norm), templates [G,D]
    (float32 or bf16; padded rows zero), valid [G] bool -> (scores [Q,k]
    float32, indices [Q,k] int64). Padded rows score -1e9; ties go to the
    lower index."""
    q = queries.float()
    q = q / (torch.linalg.vector_norm(q, dim=1, keepdim=True) + _EPS)
    sims = q @ templates.float().T
    sims = torch.where(valid[None, :], sims, torch.full_like(sims, _NEG))
    return top_k(sims, k)


class DeviceGallery:
    """Padded template matrix on the device, bf16, rebuilt when identities
    change. Rows pad to a multiple of `pad_multiple`; padded rows are
    invalid (masked to -1e9 by `cosine_topk`)."""

    def __init__(self, dim: int = 512, pad_multiple: int = 128, device="cuda"):
        self.dim = dim
        self.pad_multiple = pad_multiple
        self.device = resolve_device(device)
        # one generation = one tuple, swapped in a single assignment, so a
        # reader never pairs new ids with old templates
        self._state: tuple[list[str], torch.Tensor | None, torch.Tensor | None] = (
            [], None, None,
        )

    def rebuild(self, ids: list[str], templates: np.ndarray) -> None:
        """ids: G identity keys; templates: [G, dim] float32."""
        g = len(ids)
        gp = max(-(-g // self.pad_multiple) * self.pad_multiple, self.pad_multiple)
        mat = torch.zeros((gp, self.dim), dtype=torch.float32)
        val = torch.zeros((gp,), dtype=torch.bool)
        if g:
            mat[:g] = torch.as_tensor(np.asarray(templates, np.float32))
            val[:g] = True
        t = mat.to(device=self.device, dtype=torch.bfloat16)
        v = val.to(self.device)
        self._state = (list(ids), t, v)

    def device_snapshot(self):
        """(templates [Gpad,D] bf16, valid [Gpad], ids) of ONE generation;
        the batcher's gallery provider."""
        ids, t, v = self._state
        return t, v, list(ids)

    @property
    def size(self) -> int:
        return len(self._state[0])

    def search(self, queries, top_k: int = 5):
        """queries [Q,dim] -> (scores [Q,k] numpy float32, ids [Q][k]); k is
        clipped to the number of enrolled identities."""
        q = torch.as_tensor(np.asarray(queries, np.float32)).reshape(-1, self.dim)
        ids_list, templates, valid = self._state
        if not ids_list:
            return np.zeros((q.shape[0], 0), np.float32), [[] for _ in range(q.shape[0])]
        k = min(top_k, len(ids_list))
        scores, idx = cosine_topk(q.to(self.device), templates, valid, k)
        scores = scores.cpu().numpy()
        idx = idx.cpu().numpy()
        return scores, [[ids_list[j] for j in row] for row in idx]
