"""lfw_impostor_helper CLI: sample impostor probes from an LFW-style tree.

Counterpart of `facerecognitionpipeline_tpu/cli/lfw_impostor_helper.py`
(the reference script, `lfw_impostor_helper.py:16-39`), standard library
only, so it takes no --device: copy one image each from N identities chosen
with a seeded `random.Random` into `probe_negative/lfw_NNN.<ext>`.
"""

from __future__ import annotations

import argparse
import os
import random
import shutil

from facerecognitionpipeline_tpu_torch.utils.io import list_images


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Sample LFW identities as impostor probes"
    )
    p.add_argument("--lfw_dir", type=str, required=True,
                   help="LFW root: one subdirectory per identity")
    p.add_argument("--output_dir", type=str,
                   default=os.path.join("output", "preprocessed", "probe_negative"))
    p.add_argument("--num_identities", type=int, default=200)
    p.add_argument("--seed", type=int, default=0)
    return p


def sample_impostors(
    lfw_dir: str, output_dir: str, num_identities: int = 200, seed: int = 0
) -> int:
    identities = sorted(
        d for d in os.listdir(lfw_dir) if os.path.isdir(os.path.join(lfw_dir, d))
    )
    if not identities:
        print(f"No identity directories under {lfw_dir}")
        return 0
    rng = random.Random(seed)
    chosen = rng.sample(identities, min(num_identities, len(identities)))
    os.makedirs(output_dir, exist_ok=True)
    copied = 0
    for idx, ident in enumerate(chosen):
        images = list_images(os.path.join(lfw_dir, ident))
        if not images:
            continue
        ext = os.path.splitext(images[0])[1].lower() or ".jpg"
        shutil.copy2(images[0], os.path.join(output_dir, f"lfw_{idx:03d}{ext}"))
        copied += 1
    print(f"Copied {copied} impostor probes from {len(chosen)} identities "
          f"to {output_dir}")
    return copied


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    n = sample_impostors(
        args.lfw_dir, args.output_dir, args.num_identities, args.seed
    )
    return 0 if n > 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
