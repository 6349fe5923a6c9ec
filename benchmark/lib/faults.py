"""Faults planted in the program for checking the comparison that decides
`correct` (never in a measured run): each alters the step's answer where
it is produced, in the engine's `process_frames`, before the batcher fans
it out.

  boxes       every box moved 12 px to the right
  landmarks   every landmark moved 12 px to the right
  crop        every aligned crop shifted one pixel to the right
  gate        every valid face's gate decision flipped
  match       every match id replaced by its neighbour row's
  embedding   every embedding turned away from the served one
  half_batch  the second half of the batch answered with the first half's
"""

from __future__ import annotations

import torch

FAULTS = ("boxes", "landmarks", "crop", "gate", "match", "embedding", "half_batch")


def alter(out: dict, fault: str) -> dict:
    out = dict(out)
    if fault == "boxes":
        out["bboxes"] = out["bboxes"] + torch.tensor([12.0, 0.0, 12.0, 0.0],
                                                     device=out["bboxes"].device)
    elif fault == "landmarks":
        lm = out["landmarks"].clone()
        lm[..., 0] += 12.0
        out["landmarks"] = lm
    elif fault == "crop":
        out["aligned"] = torch.roll(out["aligned"], 1, dims=3)
    elif fault == "gate":
        out["quality_ok"] = out["quality_ok"] ^ out["face_valid"]
    elif fault == "match":
        out["match_idx"] = out["match_idx"] ^ 1
    elif fault == "embedding":
        e = out["embeddings"].clone()
        e[..., 0] += 0.5
        out["embeddings"] = torch.nn.functional.normalize(e, dim=-1)
    elif fault == "half_batch":
        b = out["face_valid"].shape[0]
        src = torch.arange(b, device=out["face_valid"].device) % max(1, b // 2)
        out = {k: ({kk: vv[src] for kk, vv in v.items()} if isinstance(v, dict) else v[src])
               for k, v in out.items()}
    else:
        raise ValueError(f"unknown fault {fault!r}; known: {', '.join(FAULTS)}")
    return out


def plant(engine, fault: str) -> None:
    """Make `engine.process_frames` answer with `fault` (this instance)."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; known: {', '.join(FAULTS)}")
    real = engine.process_frames

    def broken(*a, **kw):
        return alter(real(*a, **kw), fault)

    engine.process_frames = broken
