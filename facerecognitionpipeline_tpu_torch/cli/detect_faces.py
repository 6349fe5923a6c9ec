"""detect_faces CLI: batch-detect a directory, save aligned crops + overlays.

Capability parity with the reference's `process_classroom_images` /
`visualize_detections` module tools (face_recognition.py:218-359): every
image in --input_dir runs detect->align->gate; valid aligned crops are saved
to `<output>/aligned_faces/` and annotated bbox/landmark overlays to
`<output>/visualizations/` (green = passed the quality gate, red = rejected).
The JAX package's flags plus --device (default cuda; cpu for a run without a
card).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from facerecognitionpipeline_tpu_torch.utils.io import imread_rgb, imwrite_rgb, list_images


def draw_detections(image_rgb: np.ndarray, faces: list) -> np.ndarray:
    import cv2

    img = image_rgb.copy()
    for idx, face in enumerate(faces):
        color = (0, 255, 0) if face["is_valid"] else (255, 0, 0)
        x1, y1, x2, y2 = [int(v) for v in np.asarray(face["bbox"])]
        cv2.rectangle(img, (x1, y1), (x2, y2), color, 2)
        for lx, ly in np.asarray(face["landmarks"]):
            cv2.circle(img, (int(lx), int(ly)), 2, (255, 0, 0), -1)
        m = face["quality_metrics"]
        label = (f"{idx+1}: {face['det_score']:.2f} "
                 f"blur {m.get('blur_score', 0):.0f} yaw {m.get('yaw', 0):.0f}")
        cv2.putText(img, label, (x1, max(14, y1 - 6)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.45, color, 1)
    return img


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Detect, align and visualize faces for a directory of images"
    )
    p.add_argument("--input_dir", type=str, required=True)
    p.add_argument("--output_dir", type=str, default="output/classroom_detection")
    p.add_argument("--output_size", type=int, default=224)
    p.add_argument("--det_thresh", type=float, default=0.5)
    p.add_argument("--detector_weights", type=str, default=None)
    p.add_argument("--no_visualize", action="store_true")
    # permissive classroom gate (face_recognition.py:285-292)
    p.add_argument("--min_det_score", type=float, default=0.5)
    p.add_argument("--min_face_size", type=int, default=40)
    p.add_argument("--blur_threshold", type=float, default=50.0)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from facerecognitionpipeline_tpu_torch.models.detector import MTCNNDetector
    from facerecognitionpipeline_tpu_torch.pipeline.processor import FaceProcessor

    detector = None
    if args.detector_weights:
        detector = MTCNNDetector(
            det_size=(640, 640), det_thresh=args.det_thresh,
            weights_path=args.detector_weights, device=args.device,
        )
    processor = FaceProcessor(
        output_size=args.output_size,
        det_size=(640, 640),
        det_thresh=args.det_thresh,
        detector=detector,
        quality_filter_config={
            "min_det_score": args.min_det_score,
            "min_face_size": args.min_face_size,
            "max_yaw": 60, "max_pitch": 45, "max_roll": 45,
            "check_blur": True, "blur_threshold": args.blur_threshold,
        },
        device=args.device,
    )

    aligned_dir = os.path.join(args.output_dir, "aligned_faces")
    viz_dir = os.path.join(args.output_dir, "visualizations")
    os.makedirs(aligned_dir, exist_ok=True)
    if not args.no_visualize:
        os.makedirs(viz_dir, exist_ok=True)

    totals = {"images": 0, "faces": 0, "valid": 0}
    for path in list_images(args.input_dir):
        name = os.path.splitext(os.path.basename(path))[0]
        image = imread_rgb(path)
        if image is None:
            continue
        faces = processor.process_numpy(image, return_all=True)
        totals["images"] += 1
        totals["faces"] += len(faces)
        for idx, face in enumerate(faces):
            if not face["is_valid"]:
                continue
            totals["valid"] += 1
            imwrite_rgb(
                os.path.join(aligned_dir, f"{name}_face{idx:02d}.jpg"),
                face["aligned_face"],
            )
        if not args.no_visualize and faces:
            imwrite_rgb(
                os.path.join(viz_dir, f"{name}_detection.jpg"),
                draw_detections(image, faces),
            )
        print(f"{os.path.basename(path)}: {len(faces)} faces "
              f"({sum(f['is_valid'] for f in faces)} valid)")

    print(
        f"SUMMARY: {totals['images']} images, {totals['faces']} faces, "
        f"{totals['valid']} valid -> {aligned_dir}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
