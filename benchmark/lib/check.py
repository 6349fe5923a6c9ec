"""The comparison that decides `correct`.

It judges the answers the window's futures returned, for a seeded sample
of them, across the five layers. The reference (`benchmark/reference/`)
runs once the window has closed and the program is freed. It detects on
the frame itself; from there on it follows the program's own answers
stage by stage, which is what a served frame's later layers see:

  det_miss      faces confident on one side (score >= 0.9) with no valid
                face at IoU >= 0.5 on the other, over the sample
  det_box_px    the widest gap of a box corner between such pairs, px
  det_lmk_px    the widest gap of a landmark between such pairs, px
  align_levels  the widest gap between a served aligned crop and the
                reference's crop of the frame at the served landmarks
  gate_flips    faces whose served gate differs from the reference's gate
                on the served scores, boxes, landmarks and crops
  embed_gap     the largest 1 - cos between a served embedding and the
                reference's embedding of the served crop (valid faces)
  match_gap     the widest gap between a served top-k score and the
                reference's, or between the reference's score of a served
                id and its own score at that rank (valid faces)
  failed        frames whose future raised

The limits are the configuration file's `limits`, set from readings of
sound runs and of the control as `PERF.md` records.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import align as ref_align
from benchmark.reference import irse as ref_irse

CONFIDENT = 0.9
NAMES = ("det_miss", "det_box_px", "det_lmk_px", "align_levels", "gate_flips",
         "embed_gap", "match_gap", "failed")


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[N, 4] x [M, 4] -> [N, M]."""
    iw = np.clip(np.minimum(a[:, None, 2], b[None, :, 2]) - np.maximum(a[:, None, 0], b[None, :, 0]), 0, None)
    ih = np.clip(np.minimum(a[:, None, 3], b[None, :, 3]) - np.maximum(a[:, None, 1], b[None, :, 1]), 0, None)
    inter = iw * ih
    area = lambda z: (z[:, 2] - z[:, 0]) * (z[:, 3] - z[:, 1])  # noqa: E731
    return inter / np.maximum(area(a)[:, None] + area(b)[None] - inter, 1e-9)


def detection(prog: dict, ref: dict) -> tuple:
    """(misses, widest corner gap, widest landmark gap) of one frame."""
    miss, box, lmk = 0, 0.0, 0.0
    sides = ((prog, ref), (ref, prog))
    for a, b in sides:
        conf = np.flatnonzero(a["valid"] & (a["scores"] >= CONFIDENT))
        other = np.flatnonzero(b["valid"])
        if not len(conf):
            continue
        if not len(other):
            miss += len(conf)
            continue
        iou = _iou(a["bboxes"][conf], b["bboxes"][other])
        for r, i in enumerate(conf):
            j = other[int(iou[r].argmax())]
            if iou[r].max() < 0.5:
                miss += 1
                continue
            box = max(box, float(np.abs(a["bboxes"][i] - b["bboxes"][j]).max()))
            lmk = max(lmk, float(np.abs(a["landmarks"][i] - b["landmarks"][j]).max()))
    return miss, box, lmk


class Reference:
    """The reference side of one configuration, on one device."""

    def __init__(self, cfg: dict, cascade, embedder, rows: torch.Tensor, device):
        self.cfg = cfg
        self.cascade = cascade
        self.embedder = embedder
        self.rows = rows
        # the served gallery keeps int8 codes only at streaming scale
        self.int8_gallery = (cfg.get("gallery_quantize") == "int8"
                             and int(cfg["gallery_ids"]) >= int(cfg["streaming_from_ids"]))
        self.codes, self.row_scales = (
            ref_align.quantize_rows(rows) if self.int8_gallery else (rows, None))
        self.dev = torch.device(device)

    def match(self, q: torch.Tensor, k: int) -> tuple:
        return ref_align.match(q, self.codes, k, self.row_scales)

    def embed(self, faces: np.ndarray) -> torch.Tensor:
        return embed(self.embedder, faces, self.dev)

    def scores_at(self, q: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """The reference's scores of queries [Q, D] at gallery rows idx [Q, k]."""
        q = q.float()
        q = q / (torch.linalg.vector_norm(q, dim=1, keepdim=True) + 1e-8)
        if not self.int8_gallery:
            return torch.einsum("qd,qkd->qk", q, self.rows[idx])
        qc, qs = ref_align.quantize_rows(q)
        dots = torch.einsum("qd,qkd->qk", qc, self.codes[idx])
        return dots * self.row_scales[idx] * qs[:, None]


def embed(embedder, faces: np.ndarray, device, block: int = 64) -> torch.Tensor:
    """uint8 faces [N, 112, 112, 3] (host) -> [N, 512], in blocks."""
    out = [embedder(ref_irse.preprocess(torch.from_numpy(
        np.ascontiguousarray(faces[i:i + block])).to(device)))
        for i in range(0, len(faces), block)]
    return torch.cat(out) if out else torch.zeros((0, 512), device=device)


def compare(ref: Reference, frames: np.ndarray, answers: list, failed: int,
            control_embed=None) -> dict:
    """answers: [(pool index, answer dict of numpy arrays)]. control_embed,
    for the control of an int8 configuration: faces -> embeddings that take
    the program's place (its matches are then the reference's own)."""
    k = int(ref.cfg["top_k"])
    vals = dict.fromkeys(NAMES, 0.0)
    vals["failed"] = float(failed)
    qcfg = ref.cfg["quality"]
    with torch.inference_mode():
        for fi, a in answers:
            frame = frames[fi]
            valid = a["face_valid"].astype(bool)
            d = ref.cascade.detect(frame)
            miss, box, lmk = detection(
                {"bboxes": a["bboxes"], "scores": a["det_scores"], "landmarks": a["landmarks"],
                 "valid": valid}, d)
            vals["det_miss"] += miss
            vals["det_box_px"] = max(vals["det_box_px"], box)
            vals["det_lmk_px"] = max(vals["det_lmk_px"], lmk)
            fr = torch.from_numpy(frame).to(ref.dev)
            lm = torch.from_numpy(a["landmarks"]).float().to(ref.dev)
            crops = torch.from_numpy(a["aligned"]).to(ref.dev)
            r_al = ref_align.align(fr, lm)
            if valid.any():
                gap = (crops.float() - r_al).abs()[torch.from_numpy(valid).to(ref.dev)]
                vals["align_levels"] = max(vals["align_levels"], float(gap.max()))
            ok = ref_align.gate(
                torch.from_numpy(a["det_scores"]).float().to(ref.dev),
                torch.from_numpy(a["bboxes"]).float().to(ref.dev), lm,
                torch.from_numpy(valid).to(ref.dev), crops, qcfg).cpu().numpy()
            vals["gate_flips"] += int((ok != a["quality_ok"].astype(bool)).sum())
            if not valid.any():
                continue
            faces = a["aligned"][valid]
            r_emb = ref.embed(faces)
            if control_embed is None:
                p_emb = torch.from_numpy(a["embeddings"][valid]).float().to(ref.dev)
                p_s = torch.from_numpy(a["match_scores"][valid]).float().to(ref.dev)
                p_i = torch.from_numpy(a["match_idx"][valid]).long().to(ref.dev)
            else:
                p_emb = control_embed(faces)
                p_s, p_i = ref.match(p_emb, k)
            cos = (torch.nn.functional.normalize(p_emb, dim=1) * r_emb).sum(1)
            vals["embed_gap"] = max(vals["embed_gap"], float((1 - cos).max()))
            r_s, _ = ref.match(p_emb, k)
            at = ref.scores_at(p_emb, p_i)
            gap = torch.maximum((p_s - r_s).abs(), (at - r_s).abs())
            vals["match_gap"] = max(vals["match_gap"], float(gap.max()))
    return vals


def verdict(vals: dict, limits: dict) -> bool:
    return all(vals[n] <= limits[n] for n in NAMES)
