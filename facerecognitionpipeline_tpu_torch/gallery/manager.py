"""Gallery manager: the identity store behind enrollment, matching, serving.

Counterpart of `facerecognitionpipeline_tpu/gallery/manager.py`, and its own
copy: numpy, locks and files, on the port's `DeviceGallery`. Same pickle
`{sid: record}` + JSON metadata sidecar schemas, same aggregation
(mean/median/weighted_mean with L2 norm), same intra-similarity quality
filter and median-based outlier removal, same search result tuples. A
gallery saved by either package's manager loads in the other: a renaming
Unpickler maps any module's `StudentRecord` onto the local class, so
loading never imports the module that wrote the file.
"""

from __future__ import annotations

import json
import os
import pickle
import threading
from dataclasses import dataclass, field
from datetime import datetime
from typing import Dict, List, Optional, Tuple

import numpy as np

from facerecognitionpipeline_tpu_torch.gallery.search import DeviceGallery

_EPS = 1e-8


@dataclass
class StudentRecord:
    student_id: str
    name: str
    embeddings: np.ndarray          # [N, 512]
    template_embedding: np.ndarray  # [512]
    num_samples: int
    enrollment_date: str
    last_updated: str
    metadata: Dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "student_id": self.student_id,
            "name": self.name,
            "embeddings": np.asarray(self.embeddings).tolist(),
            "template_embedding": np.asarray(self.template_embedding).tolist(),
            "num_samples": self.num_samples,
            "enrollment_date": self.enrollment_date,
            "last_updated": self.last_updated,
            "metadata": self.metadata or {},
        }

    @classmethod
    def from_dict(cls, data: dict) -> "StudentRecord":
        return cls(
            student_id=data["student_id"],
            name=data["name"],
            embeddings=np.asarray(data["embeddings"], dtype=np.float32),
            template_embedding=np.asarray(data["template_embedding"], dtype=np.float32),
            num_samples=data["num_samples"],
            enrollment_date=data["enrollment_date"],
            last_updated=data["last_updated"],
            metadata=data.get("metadata", {}) or {},
        )


class _CompatUnpickler(pickle.Unpickler):
    """Load gallery pickles written elsewhere (the JAX package's manager,
    the reference implementation): any module's StudentRecord class
    resolves to ours."""

    def find_class(self, module, name):
        if name == "StudentRecord":
            return StudentRecord
        return super().find_class(module, name)


class GalleryManager:
    """Identity gallery with persistence, aggregation and on-device search."""

    def __init__(
        self,
        gallery_path: Optional[str] = None,
        aggregation_method: str = "mean",
        verbose: bool = True,
        mesh=None,
        quantize: Optional[str] = None,
        device="cuda",
    ):
        """mesh: row-shard the device templates over the mesh's 'data'
        axis (`DeviceGallery(mesh=...)`); `device_snapshot` then hands out
        the per-shard form that the engine's `shard_gallery=True` consumes.
        quantize: None or 'int8' — at streaming scale the device templates
        become int8 codes + per-row scales (half the device-memory bytes of
        bf16; top-1 parity pinned in tests/test_torch_port_gallery.py).
        device: where the template matrix lives; 'cuda' raises without a
        card, CPU runs pass device='cpu'."""
        if gallery_path is None:
            gallery_path = os.path.join(os.getcwd(), "gallery", "students.pkl")
        self.gallery_path = gallery_path
        self.aggregation_method = aggregation_method
        self.verbose = verbose
        self.students: Dict[str, StudentRecord] = {}
        self._device = DeviceGallery(mesh=mesh, quantize=quantize, device=device)
        self._dirty = True
        # Serializes the students-dict-mutation + dirty-flag transitions
        # against _sync_device's read-rebuild-clear: without it, a mutation
        # landing between the sync's read and its `_dirty = False` is LOST
        # and the device gallery serves stale templates until the next
        # mutation. The manager is shared across the server's HTTP thread
        # pool and the batcher's dispatch thread.
        self._sync_lock = threading.RLock()

        os.makedirs(os.path.dirname(gallery_path) or ".", exist_ok=True)
        if os.path.exists(gallery_path):
            self.load()
            self._log(f"Loaded gallery with {len(self.students)} students")
        else:
            self._log("Initialized empty gallery")

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(msg)

    # ------------------------------------------------------------- mutation

    def add_student(
        self,
        student_id: str,
        name: str,
        embeddings: np.ndarray,
        metadata: Optional[Dict] = None,
        overwrite: bool = False,
    ) -> bool:
        embeddings = np.atleast_2d(np.asarray(embeddings, dtype=np.float32))
        template = self._aggregate_embeddings(embeddings)
        now = datetime.now().isoformat()
        with self._sync_lock:
            # existence check inside the lock: two concurrent adds of the
            # same id must not both pass an unlocked check and both "succeed"
            if student_id in self.students and not overwrite:
                self._log(
                    f"Student {student_id} already exists. "
                    "Use overwrite=True to replace."
                )
                return False
            self.students[student_id] = StudentRecord(
                student_id=student_id,
                name=name,
                embeddings=embeddings,
                template_embedding=template,
                num_samples=len(embeddings),
                enrollment_date=now,
                last_updated=now,
                metadata=metadata or {},
            )
            self._dirty = True
        self._log(
            f"{'Updated' if overwrite else 'Added'} student: {name} ({student_id}) "
            f"with {len(embeddings)} embeddings"
        )
        return True

    def update_embeddings(
        self, student_id: str, new_embeddings: np.ndarray, mode: str = "append"
    ) -> bool:
        if mode not in ("append", "replace", "merge"):
            raise ValueError(f"Unknown mode: {mode}")
        new_embeddings = np.atleast_2d(np.asarray(new_embeddings, dtype=np.float32))

        # The whole read-modify-write sits inside the lock: two concurrent
        # appends that both read the old rows before either wrote back would
        # silently drop one update.
        with self._sync_lock:
            student = self.students.get(student_id)
            if student is None:
                self._log(f"Student {student_id} not found")
                return False
            if mode == "append":
                updated = np.vstack([student.embeddings, new_embeddings])
            elif mode == "replace":
                updated = new_embeddings
            else:  # merge
                updated = self._remove_outliers(
                    np.vstack([student.embeddings, new_embeddings])
                )
            student.embeddings = updated
            student.template_embedding = self._aggregate_embeddings(updated)
            student.num_samples = len(updated)
            student.last_updated = datetime.now().isoformat()
            self._dirty = True
        self._log(
            f"Updated embeddings for {student.name} ({student_id}): "
            f"{len(updated)} total embeddings"
        )
        return True

    def delete_student(self, student_id: str) -> bool:
        with self._sync_lock:
            record = self.students.pop(student_id, None)
            if record is None:
                self._log(f"Student {student_id} not found")
                return False
            self._dirty = True
        self._log(f"Deleted student: {record.name} ({student_id})")
        return True

    # --------------------------------------------------------------- access

    def get_student(self, student_id: str) -> Optional[StudentRecord]:
        return self.students.get(student_id)

    def get_all_students(self) -> Dict[str, StudentRecord]:
        return self.students

    def get_gallery_embeddings(self) -> Tuple[np.ndarray, List[str]]:
        """Stacked template matrix + ids (reference gallery_manager.py:177-187)."""
        if not self.students:
            return np.array([]), []
        ids = list(self.students.keys())
        return (
            np.vstack([self.students[sid].template_embedding for sid in ids]),
            ids,
        )

    # --------------------------------------------------------------- search

    def _sync_device(self) -> None:
        with self._sync_lock:
            if self._dirty:
                templates, ids = self.get_gallery_embeddings()
                self._device.rebuild(
                    ids, templates if len(ids) else np.zeros((0, 512))
                )
                self._dirty = False

    def device_arrays(self):
        """(templates [Gpad,512] float32, valid [Gpad]) device tensors for fused engines."""
        self._sync_device()
        _, templates, valid, _ = self._device.snapshot()
        return templates, valid

    def device_snapshot(self):
        """(templates [Gpad,512], valid [Gpad], ids list) — one CONSISTENT
        snapshot for batched dispatch. Consumers must resolve match indices
        against the returned ids list, not a later ``id_at`` call: a gallery
        mutation between dispatch and consumption would shift indices and
        mislabel matches. The three values come from ONE DeviceGallery
        generation (a single atomic state read), so a rebuild landing
        mid-call cannot pair new ids with old templates.

        At streaming scale (>= DeviceGallery.streaming_threshold ids) the
        returned templates are the compact copy (bf16, or the int8 pair
        with quantize='int8'): the fused engine's streaming kernel then
        reads half (a quarter) of the float32 gallery bytes per step, and
        the dense matmul accepts bf16 rows too (accumulation stays f32)."""
        self._sync_device()
        ids, templates, valid, templates_bf16 = self._device.snapshot()
        return (
            templates_bf16 if templates_bf16 is not None else templates,
            valid,
            list(ids),
        )

    def id_at(self, index: int) -> Optional[str]:
        """Gallery pad-index -> student_id (None for padded slots)."""
        self._sync_device()
        ids = self._device.snapshot()[0]
        return ids[index] if 0 <= index < len(ids) else None

    def search(
        self, query_embedding: np.ndarray, top_k: int = 5
    ) -> List[Tuple[str, str, float]]:
        """Top-k (student_id, name, cosine) for one query, on the device."""
        if not self.students:
            return []
        self._sync_device()
        scores, ids = self._device.search(
            np.asarray(query_embedding, dtype=np.float32)[None], top_k
        )
        return [
            # .get: a concurrent delete between the device snapshot and this
            # lookup must degrade to the raw id, not raise KeyError
            (sid, getattr(self.students.get(sid), "name", sid), float(score))
            for sid, score in zip(ids[0], scores[0])
        ]

    def search_batch(
        self, query_embeddings: np.ndarray, top_k: int = 5
    ) -> List[List[Tuple[str, str, float]]]:
        """Batched variant for serving: [Q,512] -> per-query result lists."""
        if not self.students:
            return [[] for _ in range(len(query_embeddings))]
        self._sync_device()
        scores, ids = self._device.search(
            np.asarray(query_embeddings, dtype=np.float32), top_k
        )
        return [
            [
                (sid, getattr(self.students.get(sid), "name", sid), float(score))
                for sid, score in zip(row_ids, row_scores)
            ]
            for row_ids, row_scores in zip(ids, scores)
        ]

    # ---------------------------------------------------------- persistence

    def save(self, path: Optional[str] = None) -> None:
        """Pickle of {sid: StudentRecord} + JSON metadata sidecar — the
        reference's artifact schema (gallery_manager.py:207-232)."""
        save_path = path or self.gallery_path
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        # Serialize under the lock (a concurrent add/delete mid-pickle is a
        # RuntimeError and a torn snapshot), then write atomically: dumping
        # straight into the destination with 'wb' truncates the only good
        # on-disk copy BEFORE the new bytes exist — a crash, full disk, or
        # process kill mid-dump would destroy all enrollment data.
        with self._sync_lock:
            payload = pickle.dumps(self.students)
            meta = {
                sid: {
                    "student_id": s.student_id,
                    "name": s.name,
                    "num_samples": s.num_samples,
                    "enrollment_date": s.enrollment_date,
                    "last_updated": s.last_updated,
                    "metadata": s.metadata,
                }
                for sid, s in self.students.items()
            }
        tmp_path = save_path + ".tmp"
        with open(tmp_path, "wb") as f:
            f.write(payload)
        os.replace(tmp_path, save_path)

        # splitext, not str.replace: for a path without '.pkl' the sidecar
        # must not collide with (and overwrite) the pickle just written,
        # and a '.pkl' in a PARENT directory name must not be rewritten.
        json_path = os.path.splitext(save_path)[0] + ".json"
        json_data = {
            "num_students": len(meta),
            "last_saved": datetime.now().isoformat(),
            "students": meta,
        }
        tmp_json = json_path + ".tmp"
        with open(tmp_json, "w") as f:
            json.dump(json_data, f, indent=2)
        os.replace(tmp_json, json_path)
        self._log(f"Gallery saved to {save_path}")
        self._log(f"Metadata saved to {json_path}")

    def load(self, path: Optional[str] = None, strict: bool = False) -> None:
        """strict=True raises on a missing file instead of silently keeping
        the current records — callers that report success (the server's
        /reload_gallery) must not be able to claim a reload that never
        happened (e.g. a non-atomic rewrite racing the exists check)."""
        load_path = path or self.gallery_path
        if not os.path.exists(load_path):
            if strict:
                raise ValueError(f"gallery file not found: {load_path}")
            self._log(f"Gallery file not found: {load_path}")
            return
        with open(load_path, "rb") as f:
            loaded = _CompatUnpickler(f).load()
        with self._sync_lock:
            self.students = loaded
            self._dirty = True
        self._log(f"Gallery loaded from {load_path}")

    def load_from_backup_json(self, json_path: str) -> None:
        """Restore full records from an export_for_backup JSON (embeddings
        included) — usable to ingest backups without pickle."""
        with open(json_path) as f:
            data = json.load(f)
        restored = {
            sid: StudentRecord.from_dict(rec) for sid, rec in data["students"].items()
        }
        with self._sync_lock:
            self.students = restored
            self._dirty = True
        self._log(f"Gallery restored from backup {json_path}")

    def export_for_backup(self, backup_dir: str, backup_name: Optional[str] = None) -> str:
        """Timestamped pkl copy + full-record JSON (gallery_manager.py:246-270)."""
        os.makedirs(backup_dir, exist_ok=True)
        stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
        base = f"{backup_name}_backup_{stamp}" if backup_name else f"gallery_backup_{stamp}"
        pkl_path = os.path.join(backup_dir, f"{base}.pkl")
        json_path = os.path.join(backup_dir, f"{base}.json")

        # Dump the IN-MEMORY records: copying the on-disk pickle (the
        # reference's scheme, gallery_manager.py:246-270) produces a backup
        # pair whose .pkl silently lags the sibling .json whenever the
        # caller backed up between add_student() and save(). Serialize under
        # the lock so the pkl and json halves describe the same snapshot.
        with self._sync_lock:
            payload = pickle.dumps(self.students)
            records = {sid: s.to_dict() for sid, s in self.students.items()}
        with open(pkl_path, "wb") as f:
            f.write(payload)

        json_data = {
            "backup_date": datetime.now().isoformat(),
            "backup_name": backup_name,
            "num_students": len(records),
            "students": records,
        }
        with open(json_path, "w") as f:
            json.dump(json_data, f, indent=2)
        self._log(f"Backup saved to {backup_dir}")
        return json_path

    # ------------------------------------------------------------ analytics

    def get_statistics(self) -> Dict:
        if not self.students:
            return {
                "num_students": 0,
                "total_embeddings": 0,
                "avg_embeddings_per_student": 0,
            }
        total = sum(s.num_samples for s in self.students.values())
        return {
            "num_students": len(self.students),
            "total_embeddings": total,
            "avg_embeddings_per_student": total / len(self.students),
            "students": [
                {
                    "id": s.student_id,
                    "name": s.name,
                    "num_samples": s.num_samples,
                    "enrollment_date": s.enrollment_date,
                }
                for s in self.students.values()
            ],
        }

    # ----------------------------------------------------------- aggregation

    def _filter_quality_embeddings(
        self, embeddings: np.ndarray, min_similarity: float = 0.70
    ) -> np.ndarray:
        """Drop embeddings whose mean intra-similarity is below threshold,
        always keeping >=2 (reference gallery_manager.py:104-122).

        PRESERVED REFERENCE QUIRK: the mean divides by N (all rows, diagonal
        zeroed), not N-1 off-diagonal entries — so the effective threshold
        on the true pairwise mean is min_similarity * N/(N-1), and at N=3
        the 0.70 gate is unreachable even for identical embeddings (2/3 max)
        so the >=2 fallback always fires. Template bit-parity with the
        reference's checked-in galleries depends on matching this formula
        exactly (the JAX package pins it); fixing the divisor here
        would silently change every small-N enrollment's template."""
        if len(embeddings) <= 2:
            return embeddings
        sims = np.dot(embeddings, embeddings.T)
        np.fill_diagonal(sims, 0)
        avg = np.mean(sims, axis=1)
        mask = avg >= min_similarity
        filtered = embeddings[mask]
        if len(filtered) < 2:
            filtered = embeddings[np.argsort(avg)[-2:]]
        self._log(
            f"    Quality filter: kept {len(filtered)}/{len(embeddings)} "
            f"embeddings (threshold={min_similarity})"
        )
        return filtered

    def _aggregate_embeddings(self, embeddings: np.ndarray) -> np.ndarray:
        if len(embeddings) == 1:
            # normalize like every multi-embedding path: search assumes unit
            # templates, so an unnormalized single-sample template would
            # scale that student's every match score by its norm
            e = embeddings[0]
            return e / (np.linalg.norm(e) + _EPS)
        embeddings = self._filter_quality_embeddings(embeddings)
        if self.aggregation_method == "median":
            agg = np.median(embeddings, axis=0)
        elif self.aggregation_method == "weighted_mean":
            sims = np.dot(embeddings, embeddings.T)
            weights = np.mean(sims, axis=1)
            wsum = np.sum(weights)
            if wsum <= _EPS:
                # Degenerate set the reference leaves unhandled
                # (gallery_manager.py:96-101): mutually dissimilar
                # embeddings can sum their weights to ~0 (NaN/inf template
                # that outranks every real match in device top_k) or
                # negative (sign-FLIPPED template that anti-matches the
                # student's own probes). Fall back to the plain mean.
                agg = np.mean(embeddings, axis=0)
            else:
                weights = weights / wsum
                agg = np.sum(embeddings * weights[:, None], axis=0)
        else:  # 'mean' and unknown methods fall back to mean, like the reference
            agg = np.mean(embeddings, axis=0)
        return agg / (np.linalg.norm(agg) + _EPS)

    def _remove_outliers(
        self, embeddings: np.ndarray, threshold: float = 0.7
    ) -> np.ndarray:
        """Keep embeddings whose mean similarity >= median * threshold
        (reference gallery_manager.py:319-330)."""
        if len(embeddings) <= 2:
            return embeddings
        sims = np.dot(embeddings, embeddings.T)
        avg = np.mean(sims, axis=1)
        keep = embeddings[avg >= np.median(avg) * threshold]
        if len(keep) == 0:
            # Degenerate case the reference leaves unhandled: with a
            # NEGATIVE median (mutually dissimilar set), median*0.7 sits
            # ABOVE the median and can exceed every row, emptying the set —
            # np.mean of it would then install an all-NaN template, and NaN
            # scores can outrank every real match in the device top-k.
            # Keeping the full set preserves reference behavior everywhere
            # the reference behaves at all.
            return embeddings
        return keep
