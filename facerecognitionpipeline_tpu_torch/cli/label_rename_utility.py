"""label_rename_utility CLI: interactively fix mislabeled probe files.

Counterpart of `facerecognitionpipeline_tpu/cli/label_rename_utility.py`
(the reference script, `label_rename_utility.py:17-47`), the standard
library and cv2 only, so it takes no --device: step through the images of
a labeled directory, show each (a cv2 window when a display is available,
text otherwise), and either re-prefix the file with a corrected name or move
it into `true_impostors/`. `--headless` never opens a window.
"""

from __future__ import annotations

import argparse
import os
import shutil

from facerecognitionpipeline_tpu_torch.utils.io import list_images


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Interactively relabel probe images")
    p.add_argument("--input_dir", type=str, required=True,
                   help="Directory of '{label}_{file}'-named probe images")
    p.add_argument("--impostor_dir", type=str, default=None,
                   help="Where to move true impostors "
                        "(default: <input_dir>/true_impostors)")
    p.add_argument("--corrected_dir", type=str, default=None,
                   help="Where to move corrected files "
                        "(default: <input_dir>/corrected)")
    p.add_argument("--headless", action="store_true",
                   help="Never open cv2 windows; print filenames only")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    impostor_dir = args.impostor_dir or os.path.join(args.input_dir, "true_impostors")
    corrected_dir = args.corrected_dir or os.path.join(args.input_dir, "corrected")
    os.makedirs(impostor_dir, exist_ok=True)
    os.makedirs(corrected_dir, exist_ok=True)

    show = not args.headless
    if show:
        try:
            import cv2
        except ImportError:
            show = False

    paths = list_images(args.input_dir)
    if not paths:
        print(f"No images in {args.input_dir}")
        return 1

    print(
        "Commands: ENTER keep | i -> move to true_impostors | "
        "<new_label> -> rename prefix and move to corrected | q quit"
    )
    for path in paths:
        fname = os.path.basename(path)
        if show:
            img = cv2.imread(path)
            if img is not None:
                try:
                    cv2.imshow("probe", img)
                    cv2.waitKey(100)
                except cv2.error:
                    # headless host (no X/Qt): degrade to filenames-only as
                    # documented instead of aborting the labeling session
                    print("  (no display available; continuing text-only)")
                    show = False
        try:
            cmd = input(f"{fname} > ").strip()
        except EOFError:
            break
        if cmd == "q":
            break
        if cmd == "":
            continue
        if cmd == "i":
            shutil.move(path, os.path.join(impostor_dir, fname))
            print(f"  moved to {impostor_dir}")
        else:
            # replace the '{label}_' prefix with the corrected label
            rest = fname.split("_", 1)[1] if "_" in fname else fname
            new_name = f"{cmd}_{rest}"
            shutil.move(path, os.path.join(corrected_dir, new_name))
            print(f"  renamed to {new_name} in {corrected_dir}")
    if show:
        try:
            cv2.destroyAllWindows()
        except Exception:
            pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
