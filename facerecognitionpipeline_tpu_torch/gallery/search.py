"""Device-side gallery search: one matmul + top-k, or the streaming kernels.

Counterpart of the single-device paths of
`facerecognitionpipeline_tpu/gallery/search.py`: the dense `cosine_topk`,
`_local_topk`'s arms (dense, dense dequantising, streaming bf16 = kernel K3,
streaming int8 = kernel K4, both in `ops/gallery_kernel.py`) and
`DeviceGallery`. The sharded searches (`sharded_cosine_topk`,
`dp_sharded_cosine_topk`) are queued in ROADMAP.md with multi-GPU serving.
"""

from __future__ import annotations

import numpy as np
import torch

from facerecognitionpipeline_tpu_torch.ops.gallery_kernel import (
    normalize_queries,
    quantize_templates,
    streaming_cosine_topk,
    streaming_cosine_topk_int8,
)
from facerecognitionpipeline_tpu_torch.ops.nms import top_k
from facerecognitionpipeline_tpu_torch.utils.device import resolve_device

_NEG = -1e9


def _pad_to(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def template_rows(templates) -> int:
    """Row count of a template operand: a plain [G, D] matrix or an (int8
    [G, D], per-row scales [G]) pair from `quantize_templates`."""
    t = templates[0] if isinstance(templates, tuple) else templates
    return t.shape[0]


def _masked_topk(sims, valid, k):
    sims = torch.where(valid[None, :], sims, torch.full_like(sims, _NEG))
    return top_k(sims, k)


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
    return _masked_topk(normalize_queries(queries) @ templates.float().T, valid, k)


def _local_topk(q, t, v, top_k: int, streaming: bool, chunk: int):
    """One device's scoring of queries against its template rows.

    streaming=True runs the streaming kernels (bf16 rows, or int8 when `t`
    is a (codes, scales) pair): one read of the gallery, no [Q, G] matrix.
    False is the dense matmul + top-k; for a pair it dequantises (codes
    widened to bf16, one matmul, x scales), the arm for pairs whose rows do
    not divide the chunk."""
    if isinstance(t, tuple):
        tq, sc = t
        if streaming:
            return streaming_cosine_topk_int8(q, tq, sc, v, top_k=top_k, chunk=chunk)
        sims = (normalize_queries(q) @ tq.to(torch.bfloat16).float().T) * sc[None, :]
        return _masked_topk(sims, v, top_k)
    if streaming:
        return streaming_cosine_topk(q, t, v, top_k=top_k, chunk=chunk)
    return cosine_topk(q, t, v, top_k)


class DeviceGallery:
    """Padded template matrix on the device, rebuilt when identities change.

    Below `streaming_threshold` identities the templates stay float32, rows
    padded to `pad_multiple`, and `search` is the dense matmul. At or above
    it, rows pad to `STREAM_CHUNK` and a compact copy is kept beside the
    float32 master -- bf16, or int8 codes + per-row scales with
    `quantize='int8'` -- which `search` and the serving step stream through
    kernel K3 or K4. Padded rows are zero and invalid."""

    STREAM_CHUNK = 4096

    def __init__(
        self,
        dim: int = 512,
        pad_multiple: int = 128,
        streaming_threshold: int = 32768,
        mesh=None,
        quantize: str | None = None,
        device="cuda",
    ):
        if mesh is not None:
            raise NotImplementedError(
                "mesh: the row-sharded gallery is queued in ROADMAP.md "
                "(queue 1, multi-GPU)"
            )
        if quantize not in (None, "int8"):
            raise ValueError(f"unknown quantize mode {quantize!r}")
        self.quantize = quantize
        self.dim = dim
        self.pad_multiple = pad_multiple
        self.streaming_threshold = streaming_threshold
        self.device = resolve_device(device)
        # one generation = one tuple (ids, templates, valid, compact), swapped
        # in a single assignment, so a reader never pairs new ids with old
        # templates
        self._state: tuple = ([], None, None, None)

    def rebuild(self, ids: list[str], templates) -> None:
        """ids: G identity keys; templates: [G, dim] float32, a numpy array
        or a tensor (one already on the device is padded there, without a
        host copy)."""
        g = len(ids)
        streaming = g >= self.streaming_threshold
        multiple = self.STREAM_CHUNK if streaming else self.pad_multiple
        gp = max(_pad_to(g, multiple), multiple)
        t = torch.zeros((gp, self.dim), dtype=torch.float32, device=self.device)
        v = torch.zeros((gp,), dtype=torch.bool, device=self.device)
        if g:
            if not isinstance(templates, torch.Tensor):
                templates = torch.from_numpy(np.asarray(templates, np.float32))
            t[:g] = templates.to(device=self.device, dtype=torch.float32)
            v[:g] = True
        if not streaming:
            compact = None
        elif self.quantize == "int8":
            compact = quantize_templates(t)
        else:
            compact = t.to(torch.bfloat16)
        self._state = (list(ids), t, v, compact)

    def snapshot(self):
        """(ids, templates, valid, compact) of ONE generation."""
        return self._state

    def device_snapshot(self):
        """(templates [Gpad,D] -- the compact copy at streaming scale, else
        float32 --, valid [Gpad], ids) of ONE generation; the batcher's
        gallery provider."""
        ids, t, v, compact = self._state
        return (compact if compact is not None else t), v, list(ids)

    @property
    def size(self) -> int:
        return len(self._state[0])

    def search(self, queries, top_k: int = 5):
        """queries [Q,dim] -> (scores [Q,k] numpy float32, ids [Q][k]); k is
        clipped to the number of enrolled identities."""
        q = torch.as_tensor(np.asarray(queries, np.float32)).reshape(-1, self.dim)
        # one _state read: everything below uses this single generation
        ids_list, templates, valid, compact = self._state
        if not ids_list:
            return np.zeros((q.shape[0], 0), np.float32), [[] for _ in range(q.shape[0])]
        k = min(top_k, len(ids_list))
        scores, idx = _local_topk(
            q.to(self.device),
            templates if compact is None else compact,
            valid, k, streaming=compact is not None, chunk=self.STREAM_CHUNK,
        )
        scores = scores.cpu().numpy()
        idx = idx.cpu().numpy()
        return scores, [[ids_list[j] for j in row] for row in idx]
