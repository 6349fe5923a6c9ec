"""FaceMatcher: single-face / multi-frame-track / full-image matching.

Counterpart of `facerecognitionpipeline_tpu/pipeline/matcher.py`, the
reference `FaceMatcher` (`face_matcher.py:19-500`): the same result and
summary JSON schemas (`recognition_result.json`, `recognition_summary.json`),
the same consensus rule (quality >= 0.55 votes, >= 3 frames, majority or
2x-runner-up, average winner score against the threshold) and all four
aggregation methods. A track's frames embed in one batch and are searched
in one `GalleryManager.search_batch`: on the card that is the dense matmul
below 32 768 identities and one launch of K3 (bf16 rows) or K4 (int8) at
streaming scale. `match_single_image` detects through `FaceProcessor`.
"""

from __future__ import annotations

import json
import os
from collections import Counter
from datetime import datetime
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from facerecognitionpipeline_tpu_torch.gallery.manager import GalleryManager
from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder
from facerecognitionpipeline_tpu_torch.utils.io import imread_rgb, imwrite_rgb, list_images

MIN_QUALITY = 0.55  # per-frame score for a vote (face_matcher.py:324)
MIN_FRAMES = 3      # minimum voting frames (face_matcher.py:325)

AGGREGATION_METHODS = ("consensus", "majority_vote", "avg_similarity", "max_similarity")


class FaceMatcher:
    def __init__(
        self,
        gallery_path: Optional[str] = None,
        similarity_threshold: float = 0.35,
        aggregation_method: str = "consensus",
        model_type: str = "adaface",
        architecture: str = "ir_101",
        embedder: Optional[FaceEmbedder] = None,
        gallery: Optional[GalleryManager] = None,
        processor=None,
        detector_weights: Optional[str] = None,
        device="cuda",
    ):
        """device: where the default embedder, gallery and (lazily built)
        processor run ('cuda' raises without a card; CPU runs pass
        device='cpu'). Parts passed in keep their own devices."""
        if aggregation_method not in AGGREGATION_METHODS:
            raise ValueError(
                f"Unknown aggregation: {aggregation_method}. "
                f"Choices: {AGGREGATION_METHODS}"
            )
        self.similarity_threshold = similarity_threshold
        self.aggregation_method = aggregation_method
        self.model_type = model_type
        self.architecture = architecture
        self.device = device
        self.embedder = embedder or FaceEmbedder(
            architecture=architecture, model_type=model_type, device=device
        )
        self.gallery = gallery or GalleryManager(gallery_path=gallery_path, device=device)
        self._processor = processor
        self._detector_weights = detector_weights

        n = len(self.gallery.get_all_students())
        if n == 0:
            print("\nWARNING: Gallery is empty! Please enroll students first.")
        else:
            print(f"Face Matcher ready — {n} enrolled students")

    # ------------------------------------------------------------ primitives

    def match_single_face(
        self, face_image: np.ndarray, top_k: int = 5
    ) -> List[Tuple[str, str, float]]:
        """One aligned RGB crop -> top-k (sid, name, score)."""
        embedding = self.embedder.extract_embedding(face_image, normalize=True)
        return self.gallery.search(embedding, top_k=top_k)

    def match_faces_batch(
        self, face_images, top_k: int = 5
    ) -> List[List[Tuple[str, str, float]]]:
        """Batched crops -> per-face top-k; one device forward + one matmul."""
        if len(face_images) == 0:
            return []
        embeddings = self.embedder.extract_embeddings_batch(face_images)
        return self.gallery.search_batch(embeddings, top_k=top_k)

    # ----------------------------------------------------------------- track

    def match_track(self, track_dir: str, top_k: int = 3) -> Optional[Dict]:
        """Multi-frame consensus identification over a saved track directory."""
        track_id = os.path.basename(track_dir)
        metadata_path = os.path.join(track_dir, "metadata.json")
        if not os.path.exists(metadata_path):
            print(f"No metadata found for {track_id}")
            return None
        with open(metadata_path) as f:
            metadata = json.load(f)

        paths = [p for p in list_images(track_dir)]
        frames = [(os.path.basename(p), imread_rgb(p)) for p in paths]
        frames = [(name, img) for name, img in frames if img is not None]
        if not frames:
            print(f"No face images found in {track_id}")
            return None

        # One batched embed + one batched search for the whole track.
        all_matches = self.match_faces_batch([img for _, img in frames], top_k=top_k)

        frame_matches = []
        for (fname, _), matches in zip(frames, all_matches):
            if not matches:
                continue
            sid, name, score = matches[0]
            frame_matches.append(
                {
                    "frame": fname,
                    "student_id": sid,
                    "name": name,
                    "score": float(score),
                    "top_k_matches": [
                        {"student_id": s, "name": n, "score": float(sc)}
                        for s, n, sc in matches
                    ],
                }
            )

        if not frame_matches:
            print("No valid matches found")
            return None

        final = self._aggregate_matches(frame_matches)
        if final is None:
            best = self._get_best_candidate(frame_matches)
            print(
                f"Below threshold - Best candidate: {best['name']} "
                f"({best['student_id']}) - confidence: {best['confidence']:.3f}"
            )
            return {
                "track_id": track_id,
                "recognized": False,
                "reason": "below_threshold",
                "best_candidate": best,
                "frame_matches": frame_matches,
                "metadata": metadata,
                "timestamp": datetime.now().isoformat(),
            }

        print(
            f"  Identified: {final['name']} ({final['student_id']}) "
            f"- confidence: {final['confidence']:.3f}"
        )
        return {
            "track_id": track_id,
            "recognized": True,
            "student_id": final["student_id"],
            "name": final["name"],
            "confidence": final["confidence"],
            "method": self.aggregation_method,
            "num_frames": len(frame_matches),
            "frame_matches": frame_matches,
            "metadata": metadata,
            "timestamp": datetime.now().isoformat(),
        }

    # ------------------------------------------------------------ aggregation

    def _aggregate_matches(self, frame_matches: List[Dict]) -> Optional[Dict]:
        if self.aggregation_method in ("consensus", "majority_vote"):
            return self._aggregate_consensus(
                frame_matches, strict=self.aggregation_method == "consensus"
            )
        return self._aggregate_by_score(frame_matches)

    def _aggregate_consensus(
        self, frame_matches: List[Dict], strict: bool = True
    ) -> Optional[Dict]:
        """Reference consensus rule (face_matcher.py:321-363). majority_vote
        relaxes the per-frame quality gate but keeps the majority rule."""
        quality = [m for m in frame_matches if m["score"] >= MIN_QUALITY]
        if strict:
            if len(quality) < MIN_FRAMES:
                return None
        else:
            quality = quality or frame_matches

        votes = Counter(m["student_id"] for m in quality)
        total = len(quality)
        most_common = votes.most_common(2)
        winner_id, winner_count = most_common[0]
        ratio = winner_count / total

        strong = ratio > 0.5
        if not strong and len(most_common) > 1:
            strong = ratio > 0.4 and winner_count >= 2 * most_common[1][1]
        if not strong:
            # identical in both modes — the only strict/majority_vote
            # difference is the quality-gate fallback above
            return None

        winner_scores = [m["score"] for m in quality if m["student_id"] == winner_id]
        avg = float(np.mean(winner_scores))
        if avg < self.similarity_threshold:
            return None
        name = next(m["name"] for m in quality if m["student_id"] == winner_id)
        return {
            "student_id": winner_id,
            "name": name,
            "confidence": avg,
            "consensus_strength": float(ratio),
            "num_quality_frames": len(winner_scores),
            "total_frames_evaluated": len(frame_matches),
        }

    def _aggregate_by_score(self, frame_matches: List[Dict]) -> Optional[Dict]:
        """avg_similarity / max_similarity: pick the identity with the best
        aggregated score across frames."""
        scores: Dict[str, List[float]] = {}
        names: Dict[str, str] = {}
        for m in frame_matches:
            scores.setdefault(m["student_id"], []).append(m["score"])
            names[m["student_id"]] = m["name"]
        agg = np.mean if self.aggregation_method == "avg_similarity" else np.max
        best_id = max(scores, key=lambda s: float(agg(scores[s])))
        conf = float(agg(scores[best_id]))
        if conf < self.similarity_threshold:
            return None
        return {
            "student_id": best_id,
            "name": names[best_id],
            "confidence": conf,
            "consensus_strength": len(scores[best_id]) / len(frame_matches),
            "num_quality_frames": len(scores[best_id]),
            "total_frames_evaluated": len(frame_matches),
        }

    def _get_best_candidate(self, frame_matches: List[Dict]) -> Dict:
        """Fallback candidate when consensus fails (face_matcher.py:365-385)."""
        quality = [m for m in frame_matches if m["score"] >= MIN_QUALITY]
        if not quality:
            quality = frame_matches
        votes = Counter(m["student_id"] for m in quality)
        sid = votes.most_common(1)[0][0]
        s = [m["score"] for m in quality if m["student_id"] == sid]
        name = next(m["name"] for m in quality if m["student_id"] == sid)
        return {
            "student_id": sid,
            "name": name,
            "confidence": float(np.mean(s)),
            "num_quality_frames": len(s),
        }

    # ----------------------------------------------------------- full image

    def _get_processor(self):
        if self._processor is None:
            from facerecognitionpipeline_tpu_torch.pipeline.processor import FaceProcessor

            detector = None
            if self._detector_weights:
                from facerecognitionpipeline_tpu_torch.models.detector import (
                    MTCNNDetector,
                )

                detector = MTCNNDetector(
                    det_size=(640, 640), det_thresh=0.5,
                    weights_path=self._detector_weights, device=self.device,
                )
            self._processor = FaceProcessor(
                output_size=112,
                det_size=(640, 640),
                det_thresh=0.5,
                detector=detector,
                quality_filter_config={
                    "min_det_score": 0.5,
                    "min_face_size": 40,
                    "max_yaw": 60,
                    "max_pitch": 45,
                    "max_roll": 45,
                    "check_blur": True,
                    "blur_threshold": 50,
                },
                device=self.device,
            )
        return self._processor

    def match_single_image(
        self, image_path: str, top_k: int = 5, save_visualization: bool = True
    ) -> Dict:
        """Detect -> align -> batch-embed -> match every face in one image."""
        if not os.path.exists(image_path):
            raise ValueError(f"Image not found: {image_path}")
        print(f"\nMATCHING IMAGE: {image_path}")

        faces = self._get_processor().process_image(image_path, return_all=True)
        if not faces:
            print("No faces detected in image")
            return {
                "image_path": image_path,
                "num_faces": 0,
                "matches": [],
                "timestamp": datetime.now().isoformat(),
            }
        print(f"Detected {len(faces)} face(s)")

        all_results = self.match_faces_batch(
            [f["aligned_face"] for f in faces], top_k=top_k
        )

        matches = []
        for idx, (face, results) in enumerate(zip(faces, all_results)):
            if not results:
                matches.append({"face_index": idx, "recognized": False})
                continue
            sid, name, score = results[0]
            recognized = score >= self.similarity_threshold
            state = "Recognized" if recognized else "Below threshold"
            print(f"  Face {idx + 1}: {state}: {name} ({sid}) - {score:.3f}")
            entry = {
                "face_index": idx,
                "bbox": np.asarray(face["bbox"]).tolist(),
                "recognized": recognized,
                "confidence": float(score),
                "quality_metrics": {
                    k: float(v) for k, v in face["quality_metrics"].items()
                },
                "top_matches": [
                    {"student_id": s, "name": n, "score": float(sc)}
                    for s, n, sc in results
                ],
            }
            if not recognized:
                entry["best_candidate"] = {
                    "student_id": sid,
                    "name": name,
                    "confidence": float(score),
                }
            matches.append(entry)

        result = {
            "image_path": image_path,
            "num_faces": len(faces),
            "matches": matches,
            "timestamp": datetime.now().isoformat(),
        }
        if save_visualization:
            viz = self._save_match_visualization(image_path, faces, matches)
            result["visualization_path"] = viz
        return result

    def _save_match_visualization(
        self, image_path: str, faces: List[Dict], matches: List[Dict]
    ) -> Optional[str]:
        """Annotated bbox overlay (green=match, orange=candidate, red=unknown),
        written to `<gallery>_match_results/matched_<name>` beside the input
        (reference face_matcher.py:273-319)."""
        import cv2

        image = imread_rgb(image_path)
        if image is None:
            return None
        image = image.copy()
        for face, match in zip(faces, matches):
            x1, y1, x2, y2 = [int(v) for v in np.asarray(face["bbox"])]
            if match.get("recognized"):
                color = (0, 255, 0)
                label = f"{match['top_matches'][0]['name']} {match['confidence']:.3f}"
            elif "best_candidate" in match:
                color = (255, 165, 0)
                c = match["best_candidate"]
                label = f"{c['name']}? {c['confidence']:.3f}"
            else:
                color = (255, 0, 0)
                label = "Unknown"
            cv2.rectangle(image, (x1, y1), (x2, y2), color, 3)
            cv2.putText(
                image, label, (x1, max(20, y1 - 8)),
                cv2.FONT_HERSHEY_SIMPLEX, 0.8, color, 2,
            )
        gallery_name = Path(self.gallery.gallery_path).stem
        out_dir = os.path.join(
            os.path.dirname(image_path) or ".", f"{gallery_name}_match_results"
        )
        out_path = os.path.join(out_dir, f"matched_{os.path.basename(image_path)}")
        imwrite_rgb(out_path, image)
        return out_path

    # ------------------------------------------------------------- directory

    def process_capture_directory(
        self, capture_dir: str, save_results: bool = True
    ) -> Dict:
        """Run every track_* subdirectory; write per-track results and the
        model-scoped recognition_summary.json (face_matcher.py:387-444)."""
        if not os.path.exists(capture_dir):
            raise ValueError(f"Capture directory not found: {capture_dir}")
        track_dirs = [
            os.path.join(capture_dir, d)
            for d in sorted(os.listdir(capture_dir))
            if d.startswith("track_") and os.path.isdir(os.path.join(capture_dir, d))
        ]
        if not track_dirs:
            print("No track directories found!")
            return {"error": "no_tracks"}
        print(f"Found {len(track_dirs)} tracks to process")

        results, recognized, unrecognized = [], 0, 0
        for td in track_dirs:
            result = self.match_track(td, top_k=3)
            if result is None:
                continue
            results.append(result)
            if result["recognized"]:
                recognized += 1
            else:
                unrecognized += 1
            if save_results:
                with open(os.path.join(td, "recognition_result.json"), "w") as f:
                    json.dump(result, f, indent=2)

        summary = self._generate_summary(results, recognized, unrecognized)
        if save_results:
            results_dir = os.path.join(
                capture_dir, f"{self.model_type}_{self.architecture}_results"
            )
            os.makedirs(results_dir, exist_ok=True)
            with open(os.path.join(results_dir, "recognition_summary.json"), "w") as f:
                json.dump(summary, f, indent=2)
        self._print_summary(summary)
        return summary

    def _generate_summary(
        self, results: List[Dict], recognized: int, unrecognized: int
    ) -> Dict:
        student_counts = Counter(
            r["name"] for r in results if r["recognized"]
        )
        confidences = [r["confidence"] for r in results if r["recognized"]]
        below = [
            r["best_candidate"]
            for r in results
            if not r["recognized"] and "best_candidate" in r
        ]
        return {
            "total_tracks": len(results),
            "recognized": recognized,
            "unrecognized": unrecognized,
            "recognition_rate": recognized / len(results) * 100 if results else 0,
            "avg_confidence": float(np.mean(confidences)) if confidences else 0,
            "student_appearances": dict(student_counts.most_common()),
            "below_threshold_candidates": below,
            "unique_students": len(student_counts),
            "timestamp": datetime.now().isoformat(),
            "settings": {
                "similarity_threshold": self.similarity_threshold,
                "aggregation_method": self.aggregation_method,
            },
        }

    def _print_summary(self, summary: Dict) -> None:
        print("\nRECOGNITION SUMMARY")
        print(f"  Total tracks: {summary['total_tracks']}")
        print(
            f"  Recognized: {summary['recognized']} "
            f"({summary['recognition_rate']:.1f}%)"
        )
        print(f"  Unrecognized: {summary['unrecognized']}")
        print(f"  Average confidence: {summary['avg_confidence']:.3f}")
        for name, count in summary["student_appearances"].items():
            print(f"    - {name}: {count} track(s)")
