"""probe_labeler CLI (the reference flag surface, probe_labeler.py:237-328).

The JAX package's flags plus --device (default cuda; cpu for a run without
a card) and --model_path. --top_k goes to the gallery search: at streaming
scale on the card the kernels take 1 to 14 528 and raise a ValueError beyond.
"""

from __future__ import annotations

import argparse
import os

from facerecognitionpipeline_tpu_torch.models.irse import BACKBONE_CONFIGS


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Label probe faces by matching against gallery"
    )
    p.add_argument("--probe_dir", type=str, required=True,
                   help="Directory of aligned probe face crops")
    p.add_argument("--output_dir", type=str, default=None,
                   help="Output directory (default: <probe_dir>_labeled)")
    p.add_argument("--metadata_file", type=str, default=None)
    p.add_argument("--gallery_path", type=str,
                   default=os.path.join("gallery", "students.pkl"))
    p.add_argument("--sure_threshold", type=float, default=0.5)
    p.add_argument("--unsure_threshold", type=float, default=0.4)
    p.add_argument("--no_copy", action="store_true",
                   help="Do not copy images into label directories")
    p.add_argument("--top_k", type=int, default=3)
    p.add_argument("--model_type", type=str, default="adaface",
                   choices=["adaface", "arcface"])
    p.add_argument("--architecture", type=str, default="ir_101",
                   choices=sorted(BACKBONE_CONFIGS))
    p.add_argument("--model_path", type=str, default=None,
                   help="Explicit weights path (overrides the zoo table)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from facerecognitionpipeline_tpu_torch.pipeline.labeling import ProbeLabeler

    labeler = ProbeLabeler(
        gallery_path=args.gallery_path,
        model_type=args.model_type,
        architecture=args.architecture,
        sure_threshold=args.sure_threshold,
        unsure_threshold=args.unsure_threshold,
        model_path=args.model_path,
        device=args.device,
    )
    summary = labeler.process_probe_directory(
        probe_dir=args.probe_dir,
        output_dir=args.output_dir,
        metadata_file=args.metadata_file,
        copy_files=not args.no_copy,
        top_k=args.top_k,
    )
    return 0 if not summary.get("error") else 1


if __name__ == "__main__":
    raise SystemExit(main())
