"""Complete evaluation pipeline: corpus pickles -> metrics -> exports.

Counterpart of `facerecognitionpipeline_tpu/evalharness/pipeline.py`, the
reference entry point (`run_complete_evaluation_pipeline`, temp.py:968-1141;
evaluate_models_v2.ipynb cell 33): for every model config, identification
over the 4 gallery strategies x 3 aggregations, impostor rejection,
verification, segmented per-difficulty evaluation, scored on `device`; then
cross-model comparison, gallery-strategy analysis, statistical tests and
failure analysis; JSON/CSV/LaTeX/xlsx tables (`utils/xlsx.py`, no
openpyxl), plots (matplotlib, imported at the call) and an executive
summary. Threshold sweep: 0.20-0.90 step 0.05 (temp.py:835).
"""

from __future__ import annotations

import json
import os
import pickle
from datetime import datetime
from typing import Dict, List, Optional

import numpy as np
import pandas as pd

from facerecognitionpipeline_tpu_torch.evalharness.comparison import (
    analyze_failure_cases,
    analyze_gallery_strategies,
    compare_models_statistical,
    generate_comparison_summary,
    generate_verification_summary,
)
from facerecognitionpipeline_tpu_torch.evalharness.identification import (
    evaluate_impostors_comprehensive,
    evaluate_probes_comprehensive,
    evaluate_segmented_comprehensive,
)
from facerecognitionpipeline_tpu_torch.evalharness.metrics import fmt_metric
from facerecognitionpipeline_tpu_torch.evalharness.verification import (
    evaluate_verification_comprehensive,
)
from facerecognitionpipeline_tpu_torch.utils.device import resolve_device

DEFAULT_THRESHOLDS = [round(t, 2) for t in np.arange(0.20, 0.901, 0.05)]
DEFAULT_AGGREGATIONS = ("max", "mean", "topk")
GALLERY_CONFIGS = {
    # result key -> corpus artifact stem
    "oneshot_base": "gallery_one-shot_base",
    "oneshot_augmented": "gallery_one-shot_augmented",
    "fewshot_base": "gallery_few-shot_base",
    "fewshot_augmented": "gallery_few-shot_augmented",
}


def _load_pickle(path: str):
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return pickle.load(f)


def load_model_corpus(embeddings_dir: str) -> Dict:
    """Load one model's corpus artifacts (corpus.py layout)."""
    corpus = {"galleries": {}, "probe_positive": None, "probe_positive_segmented": None,
              "probe_negative": None}
    for key, stem in GALLERY_CONFIGS.items():
        data = _load_pickle(os.path.join(embeddings_dir, f"{stem}.pkl"))
        if data:
            corpus["galleries"][key] = data
    corpus["probe_positive"] = _load_pickle(
        os.path.join(embeddings_dir, "probe_positive_unsegmented.pkl")
    )
    corpus["probe_positive_segmented"] = _load_pickle(
        os.path.join(embeddings_dir, "probe_positive_segmented.pkl")
    )
    corpus["probe_negative"] = _load_pickle(
        os.path.join(embeddings_dir, "probe_negative.pkl")
    )
    return corpus


def evaluate_model(
    corpus: Dict,
    thresholds: Optional[List[float]] = None,
    aggregations=DEFAULT_AGGREGATIONS,
    k: int = 3,
    segmented_galleries=("oneshot_base", "fewshot_base"),
    device="cuda",
) -> Dict:
    """All evaluations for one model config, scored on `device` ('cuda'
    raises without a card)."""
    thresholds = thresholds or DEFAULT_THRESHOLDS
    out: Dict = {"basic_probe": {}, "impostor": {}, "verification": {},
                 "segmented": {}}
    probes = corpus["probe_positive"]
    negatives = corpus["probe_negative"]

    for gallery_name, gallery in corpus["galleries"].items():
        if probes:
            out["basic_probe"][gallery_name] = {
                agg: evaluate_probes_comprehensive(
                    gallery, probes, thresholds, aggregation=agg, k=k,
                    device=device,
                )
                for agg in aggregations
            }
        if negatives and any(
            len(np.atleast_1d(d.get("embeddings", []))) for d in negatives.values()
        ):
            out["impostor"][gallery_name] = {
                agg: evaluate_impostors_comprehensive(
                    gallery, negatives, thresholds, aggregation=agg, k=k,
                    device=device,
                )
                for agg in aggregations
            }
            if probes:
                out["verification"][gallery_name] = {
                    agg: evaluate_verification_comprehensive(
                        gallery, probes, negatives, thresholds,
                        aggregation=agg, k=k, device=device,
                    )
                    for agg in aggregations
                }
        if corpus["probe_positive_segmented"] and gallery_name in segmented_galleries:
            out["segmented"][gallery_name] = evaluate_segmented_comprehensive(
                gallery, corpus["probe_positive_segmented"], thresholds,
                aggregation="mean", k=k, device=device,
            )
    return out


def _df_to_json(df: pd.DataFrame):
    return json.loads(df.to_json(orient="records"))


def export_results(all_model_results: Dict, output_dir: str) -> Dict:
    """Comparison tables + failure analysis + exec summary -> disk."""
    os.makedirs(output_dir, exist_ok=True)

    summary = generate_comparison_summary(all_model_results)
    verification = generate_verification_summary(all_model_results)
    strategies = analyze_gallery_strategies(all_model_results)
    statistical = compare_models_statistical(all_model_results)
    failures = analyze_failure_cases(all_model_results)

    tables = {
        "identification_summary": summary,
        "verification_summary": verification,
        "gallery_strategies": strategies,
        "statistical_comparison": statistical,
    }
    for name, df in tables.items():
        if df.empty:
            continue
        df.to_csv(os.path.join(output_dir, f"{name}.csv"), index=False)
        try:
            with open(os.path.join(output_dir, f"{name}.tex"), "w") as f:
                f.write(df.to_latex(index=False, float_format="%.4f"))
        except Exception:
            pass

    # Excel workbook, one sheet per summary table (reference
    # temp.py:502-808 `export_results_to_excel`) — written natively by
    # utils/xlsx.py, no openpyxl required
    nonempty = {name: df for name, df in tables.items() if not df.empty}
    if nonempty:
        from facerecognitionpipeline_tpu_torch.utils.xlsx import write_xlsx

        write_xlsx(
            os.path.join(output_dir, "evaluation_results.xlsx"), nonempty
        )

    blob = {
        "generated": datetime.now().isoformat(),
        "identification_summary": _df_to_json(summary),
        "verification_summary": _df_to_json(verification),
        "gallery_strategies": _df_to_json(strategies),
        "statistical_comparison": _df_to_json(statistical),
        "failure_analysis": failures,
    }
    with open(os.path.join(output_dir, "evaluation_results.json"), "w") as f:
        json.dump(blob, f, indent=2)

    exec_lines = ["EXECUTIVE SUMMARY", "=" * 60]
    if not summary.empty:
        best = summary.loc[summary["Rank-1"].idxmax()]
        exec_lines += [
            f"Best identification: {best['Model']} on {best['Gallery']} "
            f"({best['Aggregation']}) — rank-1 {best['Rank-1']:.3f}, "
            f"ROC-AUC {fmt_metric(best['ROC-AUC'])}, d' {best['d-prime']:.2f}",
        ]
    if not verification.empty:
        bestv = verification.loc[verification["EER"].idxmin()]
        exec_lines += [
            f"Best verification: {bestv['Model']} on {bestv['Gallery']} "
            f"({bestv['Aggregation']}) — EER {bestv['EER']:.4f}, "
            f"TAR@FAR=1% {bestv['TAR@FAR=1%']:.3f}",
        ]
    for name, fa in failures.items():
        exec_lines.append(
            f"{name}: error rate {fa['error_rate']:.3f} "
            f"({fa['total_errors']}/{fa['total_predictions']})"
        )
    with open(os.path.join(output_dir, "executive_summary.txt"), "w") as f:
        f.write("\n".join(exec_lines) + "\n")

    return blob


def export_plots(all_model_results: Dict, output_dir: str) -> List[str]:
    """ROC curves + rank-1 threshold sweeps per model (headless matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(output_dir, exist_ok=True)
    written = []

    fig, axes = plt.subplots(1, 2, figsize=(12, 5))
    for model_name, model_data in all_model_results.items():
        for gallery_name, gallery_results in model_data.get("basic_probe", {}).items():
            results = gallery_results.get("mean")
            if not results:
                continue
            axes[0].plot(
                results["fpr"], results["tpr"],
                label=f"{model_name}/{gallery_name} (AUC {fmt_metric(results['roc_auc'])})",
            )
            df = results["threshold_results"]
            axes[1].plot(df["threshold"], df["tar"],
                         label=f"{model_name}/{gallery_name}")
    axes[0].plot([0, 1], [0, 1], "k--", alpha=0.3)
    axes[0].set_xlabel("FPR"); axes[0].set_ylabel("TPR")
    axes[0].set_title("Identification ROC (mean agg)")
    axes[0].legend(fontsize=7)
    axes[1].set_xlabel("threshold"); axes[1].set_ylabel("TAR")
    axes[1].set_title("TAR vs threshold")
    axes[1].legend(fontsize=7)
    fig.tight_layout()
    path = os.path.join(output_dir, "identification_curves.png")
    fig.savefig(path, dpi=120)
    plt.close(fig)
    written.append(path)

    # verification ROC + genuine/impostor distributions (v2 notebook plots)
    has_ver = any(m.get("verification") for m in all_model_results.values())
    if has_ver:
        fig, axes = plt.subplots(1, 2, figsize=(12, 5))
        for model_name, model_data in all_model_results.items():
            for gallery_name, gr in model_data.get("verification", {}).items():
                v = gr.get("mean")
                if not v:
                    continue
                axes[0].plot(
                    v["fpr"], v["tpr"],
                    label=f"{model_name}/{gallery_name} (EER {v['eer']:.3f})",
                )
                axes[1].hist(v["genuine_scores"], bins=40, alpha=0.4,
                             label=f"{model_name}/{gallery_name} genuine")
                axes[1].hist(v["impostor_scores"], bins=40, alpha=0.4,
                             label=f"{model_name}/{gallery_name} impostor")
        axes[0].plot([0, 1], [0, 1], "k--", alpha=0.3)
        axes[0].set_xlabel("FAR"); axes[0].set_ylabel("TAR")
        axes[0].set_title("Verification ROC (mean agg)")
        axes[0].legend(fontsize=7)
        axes[1].set_xlabel("cosine similarity"); axes[1].set_ylabel("count")
        axes[1].set_title("Score distributions")
        axes[1].legend(fontsize=6)
        fig.tight_layout()
        path = os.path.join(output_dir, "verification_curves.png")
        fig.savefig(path, dpi=120)
        plt.close(fig)
        written.append(path)

    # per-segment rank-1 bars (difficulty-bucket comparison)
    seg_rows = []
    for model_name, model_data in all_model_results.items():
        for gallery_name, segments in model_data.get("segmented", {}).items():
            for seg_name, res in segments.items():
                seg_rows.append(
                    (f"{model_name}/{gallery_name}", seg_name,
                     float(res["threshold_results"]["rank1_accuracy"].iloc[0]))
                )
    if seg_rows:
        configs = sorted({r[0] for r in seg_rows})
        segments = sorted({r[1] for r in seg_rows})
        fig, ax = plt.subplots(figsize=(max(8, len(segments) * 1.1), 5))
        width = 0.8 / max(len(configs), 1)
        for ci, cfg in enumerate(configs):
            vals = [
                next((v for c, s, v in seg_rows if c == cfg and s == seg), 0.0)
                for seg in segments
            ]
            xs = [i + ci * width for i in range(len(segments))]
            ax.bar(xs, vals, width=width, label=cfg)
        ax.set_xticks([i + 0.4 for i in range(len(segments))])
        ax.set_xticklabels(segments, rotation=30, ha="right", fontsize=8)
        ax.set_ylabel("rank-1 accuracy")
        ax.set_title("Per-segment identification")
        ax.legend(fontsize=7)
        fig.tight_layout()
        path = os.path.join(output_dir, "segmented_rank1.png")
        fig.savefig(path, dpi=120)
        plt.close(fig)
        written.append(path)
    return written


def run_complete_evaluation_pipeline(
    models: List[str],
    embeddings_root: str,
    output_dir: str,
    thresholds: Optional[List[float]] = None,
    aggregations=DEFAULT_AGGREGATIONS,
    make_plots: bool = True,
    device="cuda",
) -> Dict:
    """models: e.g. ['adaface_ir_50', 'adaface_ir_101', ...]; embeddings_root
    is the corpus generator's `<output_root>/embeddings` directory; device:
    where the scoring runs ('cuda' raises without a card, CPU runs pass
    device='cpu')."""
    resolve_device(device)
    all_results: Dict = {}
    for model_name in models:
        model_dir = os.path.join(embeddings_root, model_name)
        if not os.path.isdir(model_dir):
            print(f"Warning: missing embeddings for {model_name} at {model_dir}")
            continue
        print(f"Evaluating {model_name}...")
        corpus = load_model_corpus(model_dir)
        if not corpus["galleries"]:
            print(f"  no gallery artifacts for {model_name}; skipping")
            continue
        all_results[model_name] = evaluate_model(
            corpus, thresholds=thresholds, aggregations=aggregations,
            device=device,
        )

    blob = export_results(all_results, output_dir)
    if make_plots and all_results:
        export_plots(all_results, output_dir)
    print(f"Evaluation complete -> {output_dir}")
    return {"results": all_results, "exports": blob}
