"""Device-side gallery search: one matmul + top-k, the streaming kernels,
and the sharded searches over a mesh.

Counterpart of `facerecognitionpipeline_tpu/gallery/search.py`: the dense
`cosine_topk`, `_local_topk`'s arms (dense, dense dequantising, streaming
bf16 = kernel K3, streaming int8 = kernel K4, both in
`ops/gallery_kernel.py`), the sharded searches `sharded_cosine_topk` and
`dp_sharded_cosine_topk`, and `DeviceGallery`.

A sharded search scores each shard of the gallery rows on that shard's
device with `_local_topk` (so K3/K4 run once per shard when streaming),
offsets the shard's indices by its first row, gathers the [Q, n*k]
candidates onto the mesh's first device and takes one stable top-k there:
value descending, then global index ascending, the order the kernels and
`jax.lax.top_k` give. With fewer valid rows than top_k a shard's surplus
slots come back as the single-device arms give them (score -1e9), their
index offset by the shard's base row.
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
from facerecognitionpipeline_tpu_torch.parallel.mesh import (
    Sharded,
    shard_blocks,
    shard_rows,
)
from facerecognitionpipeline_tpu_torch.utils.device import resolve_device

_NEG = -1e9


def _pad_to(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def template_rows(templates) -> int:
    """Row count of a template operand: a plain [G, D] matrix (a tensor or
    a `Sharded` one) or an (int8 [G, D], per-row scales [G]) pair from
    `quantize_templates`."""
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


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def _check_streaming(shard: int, streaming: bool, chunk: int) -> None:
    if streaming and shard % chunk:
        raise ValueError(
            f"streaming shards need rows % chunk == 0, got {shard} rows "
            f"per device with chunk {chunk}"
        )


def _score_shards(mesh, axis, q_parts, templates, valid, top_k, streaming, chunk):
    """Every query against every row shard: q_parts, the query shards (any
    devices), are gathered onto each row shard's device and scored there.
    -> (scores [Q, n*k], global indices [Q, n*k]) on the mesh's first
    device, shard 0's candidates first."""
    devices = mesh.axis_devices(axis)
    t = shard_rows(templates, devices)
    v = shard_rows(valid, devices)
    shard = template_rows(templates) // len(devices)
    home = mesh.first
    scores, idx = [], []
    for i, dev in enumerate(devices):
        q = torch.cat([p.to(dev) for p in q_parts])
        s, j = _local_topk(q, shard_blocks(t, i), shard_blocks(v, i), top_k,
                           streaming, chunk)
        scores.append(s.to(home))
        idx.append((j + i * shard).to(home))
    return torch.cat(scores, dim=1), torch.cat(idx, dim=1)


def _merge(scores, idx, k):
    """Global top-k of gathered candidates: stable, so equal scores keep
    the candidates' order, which is ascending global index."""
    s, pos = top_k(scores, k)
    return s, torch.gather(idx, 1, pos)


def sharded_cosine_topk(
    mesh,
    queries,
    templates,
    valid,
    top_k: int,
    axis: str = "gallery",
    streaming: bool = False,
    chunk: int = 4096,
):
    """Gallery-sharded search: template rows split over the mesh axis `axis`
    (a tensor is split here; a `Sharded` one is used as it lies), queries
    [Q, D] replicated. Each shard takes its local top-k (K3/K4 with
    streaming=True), and one merge of the [Q, n*k] candidates on the mesh's
    first device gives (scores [Q, k], indices [Q, k]) there."""
    n_dev = mesh.shape[axis]
    g = template_rows(templates)
    if g % n_dev:
        raise ValueError(
            f"gallery rows ({g}) must divide the mesh '{axis}' axis "
            f"({n_dev}); pad the template matrix (DeviceGallery does)"
        )
    shard = g // n_dev
    if top_k > shard:
        raise ValueError(
            f"top_k={top_k} exceeds the per-device shard of {shard} rows "
            f"({g} padded rows over {n_dev} devices); lower top_k or use "
            f"fewer shards"
        )
    _check_streaming(shard, streaming, chunk)
    q = _as_tensor(queries).float()
    q = q.reshape(-1, q.shape[-1])
    scores, idx = _score_shards(mesh, axis, [q], _rows(templates), _rows(valid),
                                top_k, streaming, chunk)
    return _merge(scores, idx, top_k)


def _rows(x):
    """Template operands as tensors or `Sharded` (numpy arrays become
    tensors)."""
    if isinstance(x, tuple):
        return tuple(_rows(v) for v in x)
    return x if isinstance(x, Sharded) else _as_tensor(x)


def dp_sharded_parts(mesh, q_parts, templates, valid, top_k, axis="data",
                     streaming=False, chunk=4096):
    """`dp_sharded_cosine_topk` on query shards already on their devices:
    q_parts [b_i, F, D] per shard of `axis` -> [(scores [b_i, F, k],
    indices [b_i, F, k])] on each query shard's device. The merge runs
    once, on the mesh's first device, for every query. Raises the JAX
    ValueErrors for rows that do not divide the axis, top_k above a shard
    and streaming shards whose rows do not divide `chunk`."""
    n_dev = mesh.shape[axis]
    g = template_rows(templates)
    if g % n_dev:
        raise ValueError(
            f"gallery rows ({g}) must divide the mesh '{axis}' axis "
            f"({n_dev}); pad the template matrix (DeviceGallery does)"
        )
    shard = g // n_dev
    if top_k > shard:
        raise ValueError(
            f"top_k={top_k} exceeds the per-device gallery shard of {shard} "
            f"rows; lower top_k or use fewer shards"
        )
    _check_streaming(shard, streaming, chunk)
    shapes = [p.shape for p in q_parts]
    scores, idx = _score_shards(mesh, axis, [p.reshape(-1, p.shape[-1]) for p in q_parts],
                                _rows(templates), _rows(valid), top_k, streaming, chunk)
    gs, gi = _merge(scores, idx, top_k)
    out, start = [], 0
    for p, (b, f, _) in zip(q_parts, shapes):
        n = b * f
        out.append((gs[start:start + n].reshape(b, f, top_k).to(p.device),
                    gi[start:start + n].reshape(b, f, top_k).to(p.device)))
        start += n
    return out


def dp_sharded_cosine_topk(
    mesh,
    queries,
    templates,
    valid,
    top_k: int,
    axis: str = "data",
    streaming: bool = False,
    chunk: int = 4096,
):
    """Gallery rows and the query batch sharded over the same axis: the
    engine's `shard_gallery=True`. queries [B, F, D] (batch split over
    `axis`), templates [G, D] (a tensor, a `Sharded` one, or an int8 pair
    of either) rows split over `axis`, valid [G]. Every row shard scores
    all B*F queries; the merge keeps each query's global top-k. Returns
    (scores [B, F, k], indices [B, F, k]) on the mesh's first device."""
    n_dev = mesh.shape[axis]
    g = template_rows(templates)
    if g % n_dev:
        raise ValueError(
            f"gallery rows ({g}) must divide the mesh '{axis}' axis "
            f"({n_dev}); pad the template matrix (DeviceGallery does)"
        )
    q = _as_tensor(queries).float()
    if q.shape[0] % n_dev:
        raise ValueError(
            f"query batch ({q.shape[0]}) must divide the mesh "
            f"'{axis}' axis ({n_dev})"
        )
    devices = mesh.axis_devices(axis)
    per = q.shape[0] // n_dev
    parts = [q[i * per:(i + 1) * per].to(d) for i, d in enumerate(devices)]
    out = dp_sharded_parts(mesh, parts, templates, valid, top_k, axis, streaming, chunk)
    home = mesh.first
    return (torch.cat([s.to(home) for s, _ in out]),
            torch.cat([i.to(home) for _, i in out]))


class DeviceGallery:
    """Padded template matrix on the device, rebuilt when identities change.

    Below `streaming_threshold` identities the templates stay float32, rows
    padded to `pad_multiple`, and `search` is the dense matmul. At or above
    it, rows pad to `STREAM_CHUNK` and a compact copy is kept beside the
    float32 master -- bf16, or int8 codes + per-row scales with
    `quantize='int8'` -- which `search` and the serving step stream through
    kernel K3 or K4. Padded rows are zero and invalid.

    mesh: row-shard the templates over the mesh axis `shard_axis`: padding
    rises to a multiple of n_dev x (pad_multiple or STREAM_CHUNK), and each
    shard, with its compact copy, is a tensor of its own on its device (a
    `Sharded`). `search` runs `sharded_cosine_topk` while top_k fits one
    shard, and the single-device arms on the gathered rows otherwise; the
    engine's `shard_gallery=True` consumes the shards as they lie."""

    STREAM_CHUNK = 4096

    def __init__(
        self,
        dim: int = 512,
        pad_multiple: int = 128,
        streaming_threshold: int = 32768,
        mesh=None,
        shard_axis: str = "data",
        quantize: str | None = None,
        device="cuda",
    ):
        if quantize not in (None, "int8"):
            raise ValueError(f"unknown quantize mode {quantize!r}")
        self.quantize = quantize
        self.dim = dim
        self.pad_multiple = pad_multiple
        self.streaming_threshold = streaming_threshold
        self.mesh = mesh
        self.shard_axis = shard_axis
        if mesh is not None:
            if shard_axis not in mesh.shape:
                raise ValueError(
                    f"mesh has no '{shard_axis}' axis (axes: {dict(mesh.shape)})"
                )
            self.device = mesh.first
        else:
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
        devices = [self.device]
        if self.mesh is not None:
            devices = self.mesh.axis_devices(self.shard_axis)
            multiple *= len(devices)
        gp = max(_pad_to(g, multiple), multiple)
        if g and not isinstance(templates, torch.Tensor):
            templates = torch.from_numpy(np.asarray(templates, np.float32))
        rows = gp // len(devices)
        blocks, valid = [], []
        for i, dev in enumerate(devices):
            t = torch.zeros((rows, self.dim), dtype=torch.float32, device=dev)
            v = torch.zeros((rows,), dtype=torch.bool, device=dev)
            n = min(max(g - i * rows, 0), rows)
            if n:
                t[:n] = templates[i * rows:i * rows + n].to(device=dev, dtype=torch.float32)
                v[:n] = True
            blocks.append(t)
            valid.append(v)

        def compact_of(t):
            if self.quantize == "int8":
                return quantize_templates(t)
            return t.to(torch.bfloat16)

        if self.mesh is None:
            t, v = blocks[0], valid[0]
            compact = compact_of(t) if streaming else None
        else:
            t, v = Sharded(blocks), Sharded(valid)
            compact = None
            if streaming:
                parts = [compact_of(b) for b in blocks]
                compact = (
                    (Sharded([c for c, _ in parts]), Sharded([s for _, s in parts]))
                    if self.quantize == "int8" else Sharded(parts)
                )
        self._state = (list(ids), t, v, compact)

    def snapshot(self):
        """(ids, templates, valid, compact) of ONE generation."""
        return self._state

    def device_snapshot(self):
        """(templates [Gpad,D] -- the compact copy at streaming scale, else
        float32 --, valid [Gpad], ids) of ONE generation; the batcher's
        gallery provider. Under a mesh, the per-shard forms (`Sharded`)."""
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
        streaming = compact is not None
        rows = templates if compact is None else compact
        if self.mesh is not None and k <= templates.shape[0] // self.mesh.shape[self.shard_axis]:
            scores, idx = sharded_cosine_topk(
                self.mesh, q, rows, valid, k, axis=self.shard_axis,
                streaming=streaming, chunk=self.STREAM_CHUNK,
            )
        else:
            if self.mesh is not None:
                # top_k above one shard (toy sizes only): the whole gallery
                # on the first device
                rows = _gathered(rows, self.device)
                valid = valid.gather(self.device)
            scores, idx = _local_topk(
                q.to(self.device), rows, valid, k, streaming=streaming,
                chunk=self.STREAM_CHUNK,
            )
        scores = scores.cpu().numpy()
        idx = idx.cpu().numpy()
        return scores, [[ids_list[j] for j in row] for row in idx]


def _gathered(x, device):
    if isinstance(x, tuple):
        return tuple(_gathered(v, device) for v in x)
    return x.gather(device)
