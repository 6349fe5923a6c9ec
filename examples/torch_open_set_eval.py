"""Open-set recognition evaluation of a backbone trained by the PyTorch
port, on held-out identities.

The flags and defaults of `examples/open_set_eval.py`, plus `--device`:
200 held-out gallery identities enrolled from 4 crops, 10 known probes
each, 60 unknown identities x 10 probes, six conditions (clean, blur,
lowlight, noise, occlusion, jpeg), the fp32 tier and the int8 tier
calibrated on the enrolment crops (`evalharness/open_set.py`). Reads
pretrained/<arch>_synthetic_torch.npz (`examples/torch_train_open_set.py`)
and writes reports/openset_torch_<arch>/report.json (+ curves.png where
matplotlib imports); the JAX package's reports are left alone.

Run:  python examples/torch_open_set_eval.py [--architecture ir_50]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from facerecognitionpipeline_tpu_torch.evalharness import open_set  # noqa: E402


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--architecture", default="ir_18")
    ap.add_argument("--weights", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--conditions", nargs="*", default=list(open_set.CONDITIONS))
    ap.add_argument("--skip_int8", action="store_true")
    ap.add_argument("--device", default="cuda")
    return ap


def plot_curves(report: dict, conditions, out_dir: str) -> None:
    """Metric-vs-condition curves of each tier into out_dir/curves.png."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(15, 4))
    for tier in [t for t in ("fp32", "int8") if t in report]:
        r = report[tier]
        axes[0].plot(conditions, [r[c]["rank1"] for c in conditions], "o-", label=tier)
        axes[1].plot(conditions, [r[c]["eer"] for c in conditions], "o-", label=tier)
        axes[2].plot(conditions, [r[c]["dir_at_far_0.01"] for c in conditions], "o-",
                     label=tier)
    for ax, title in zip(axes, ("rank-1", "EER", "DIR@FAR=1%")):
        ax.set_title(title)
        ax.grid(alpha=0.3)
        ax.legend()
        ax.tick_params(axis="x", rotation=30)
    fig.suptitle(f"Open-set eval: {report['architecture']}, "
                 f"{report['protocol']['n_gallery_identities']} held-out identities + "
                 f"{report['protocol']['n_unknown_identities']} unknown")
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "curves.png"), dpi=120)
    plt.close(fig)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    weights = args.weights or f"pretrained/{args.architecture}_synthetic_torch.npz"
    out_dir = args.out or f"reports/openset_torch_{args.architecture}"
    if not os.path.exists(weights):
        print(f"weights not found: {weights} — run "
              f"examples/torch_train_open_set.py first", file=sys.stderr)
        return 1

    report = open_set.run_open_set(args.architecture, weights, args.conditions,
                                   args.skip_int8, device=args.device)
    open_set.write_report(report, out_dir)
    try:
        plot_curves(report, args.conditions, out_dir)
    except ImportError as e:  # plots are a convenience, not the artifact
        print(f"plotting skipped: {e}", file=sys.stderr)

    print(f"\nReport -> {out_dir}/report.json")
    clean = report["fp32"].get("clean")
    if clean:
        print(f"headline (fp32 clean): rank1 {clean['rank1']:.3f} "
              f"EER {clean['eer']:.3f} TAR@FAR1% {clean['tar_at_far_0.01']:.3f} "
              f"DIR@FAR1% {clean['dir_at_far_0.01']:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
