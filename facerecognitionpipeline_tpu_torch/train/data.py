"""Training data: identity-folder datasets and synthetic classes -> batches
on the card.

Counterpart of `facerecognitionpipeline_tpu/train/data.py`. The host
iterators are the JAX package's, call for call: `folder_batches` decodes in
a thread pool with the same permutation and flip stream from the seed and
the same round-robin top-up of short batches, and its producer stops when
the consumer leaves; `synthetic_batches` makes the same numpy calls in the
same order, so both give the JAX package's batches bit for bit.

`prefetch_to_device` stages batches on the card `depth` ahead: a thread
copies each into pinned host memory and on to the device on a side stream,
and an event joins that copy to the consumer's stream before the batch is
used. Errors come out on the consumer's thread.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from facerecognitionpipeline_tpu_torch.utils.device import resolve_device
from facerecognitionpipeline_tpu_torch.utils.io import imread_rgb, list_images


class FolderDataset:
    """`root/<identity>/*.jpg` -> (paths, labels, num_classes)."""

    def __init__(self, root: str, min_images_per_class: int = 1):
        self.root = root
        classes = sorted(
            d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
        )
        self.class_names: list[str] = []
        self.paths: list[str] = []
        self.labels: list[int] = []
        for cls in classes:
            images = list_images(os.path.join(root, cls))
            if len(images) < min_images_per_class:
                continue
            idx = len(self.class_names)
            self.class_names.append(cls)
            self.paths.extend(images)
            self.labels.extend([idx] * len(images))
        if not self.paths:
            raise ValueError(f"No training images under {root}")
        self.labels_np = np.asarray(self.labels, np.int32)

    @property
    def num_classes(self) -> int:
        return len(self.class_names)

    def __len__(self) -> int:
        return len(self.paths)


def _load_normalized(path: str) -> Optional[np.ndarray]:
    """RGB file -> [112,112,3] float32 BGR in [-1,1] (embedder convention)."""
    img = imread_rgb(path)
    if img is None:
        return None
    if img.shape[:2] != (112, 112):
        import cv2

        img = cv2.resize(img, (112, 112), interpolation=cv2.INTER_LINEAR)
    bgr = img[:, :, ::-1].astype(np.float32)
    return (bgr - 127.5) / 127.5


def folder_batches(
    dataset: FolderDataset,
    batch_size: int,
    seed: int = 0,
    epochs: Optional[int] = None,
    augment_flip: bool = True,
    num_workers: int = 4,
    prefetch: int = 4,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yields (images [B,112,112,3] f32, labels [B] i32) forever (or for
    `epochs`). Raises ValueError at the call, not at the first next(), when
    no full batch can ever be formed."""
    if len(dataset) < batch_size:
        raise ValueError(
            f"dataset has {len(dataset)} images < batch_size {batch_size}; "
            f"no full batch can ever be formed"
        )
    return _folder_batches_iter(
        dataset, batch_size, seed, epochs, augment_flip, num_workers, prefetch
    )


def _put_or_stop(q: "queue.Queue", stop: threading.Event, item) -> bool:
    """A put that the consumer's leaving can unblock (a plain put on a full
    queue would block the producer for ever)."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.2)
            return True
        except queue.Full:
            continue
    return False


def _folder_batches_iter(
    dataset, batch_size, seed, epochs, augment_flip, num_workers, prefetch
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    from concurrent.futures import ThreadPoolExecutor

    rng = np.random.default_rng(seed)
    out_q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()
    pool = ThreadPoolExecutor(max_workers=max(1, num_workers))

    def producer():
        try:
            produce()
        finally:
            # shut down here, not on the consumer's thread: a decode already
            # in flight then never meets a pool that is gone
            pool.shutdown(wait=False)

    def produce():
        epoch = 0
        while not stop.is_set() and (epochs is None or epoch < epochs):
            order = rng.permutation(len(dataset))
            produced = 0
            for start in range(0, len(order) - batch_size + 1, batch_size):
                if stop.is_set():
                    return
                idx = order[start : start + batch_size]
                decoded = list(pool.map(lambda i: _load_normalized(dataset.paths[i]), idx))
                imgs, labels = [], []
                for i, img in zip(idx, decoded):
                    if img is None:
                        continue
                    if augment_flip and rng.random() < 0.5:
                        img = img[:, ::-1, :]
                    imgs.append(img)
                    labels.append(dataset.labels_np[i])
                if len(imgs) < batch_size:
                    # round-robin repeats of the images that did decode keep
                    # the shape without weighting one image more
                    n_real = len(imgs)
                    while len(imgs) < batch_size and imgs:
                        k = len(imgs) % n_real
                        imgs.append(imgs[k])
                        labels.append(labels[k])
                if imgs:
                    if not _put_or_stop(out_q, stop, (np.stack(imgs), np.asarray(labels, np.int32))):
                        return
                    produced += 1
            if produced == 0:
                break  # nothing decodes: end the stream
            epoch += 1
        _put_or_stop(out_q, stop, None)

    thread = threading.Thread(target=producer, daemon=True, name="folder_batches_producer")
    thread.start()
    try:
        while True:
            item = out_q.get()
            if item is None:
                return
            yield item
    finally:
        stop.set()


def synthetic_batches(
    num_classes: int,
    batch_size: int,
    seed: int = 0,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Learnable synthetic data: each class a fixed random pattern plus a
    little noise."""
    rng = np.random.default_rng(seed)
    prototypes = rng.uniform(-1, 1, size=(num_classes, 112, 112, 3)).astype(np.float32)
    while True:
        labels = rng.integers(0, num_classes, size=batch_size).astype(np.int32)
        noise = rng.normal(0, 0.05, size=(batch_size, 112, 112, 3)).astype(np.float32)
        images = np.clip(prototypes[labels] + noise, -1, 1)
        yield images, labels


def prefetch_to_device(
    batches: Iterator[Tuple[np.ndarray, ...]],
    depth: int = 2,
    device="cuda",
    sharding=None,
) -> Iterator[Tuple]:
    """Stage host batches (tuples of arrays) on `device`, `depth` ahead.

    On the card a thread pins each array, copies it on a side stream and
    records an event; the consumer's stream waits for that event before
    the batch is yielded, and the tensors are marked as used on it. On the
    CPU the arrays become tensors on the same thread's schedule.

    sharding: a mesh; each array is then split over its 'data' axis and
    staged as one pinned copy per shard on that shard's device, and is
    yielded as the list of those shard tensors (what `Trainer.train_step`
    under the mesh takes as it lies)."""
    if sharding is not None:
        devices = sharding.axis_devices("data")
    else:
        devices = [resolve_device(device)]
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()
    done = object()
    errors: list = []

    def split(a):
        a = np.asarray(a)
        n = len(devices)
        if a.shape[0] % n:
            raise ValueError(
                f"batch of {a.shape[0]} is not a multiple of the mesh 'data' axis ({n})"
            )
        per = a.shape[0] // n
        return [np.ascontiguousarray(a[i * per:(i + 1) * per]) for i in range(n)]

    def producer():
        try:
            sides = {d: torch.cuda.Stream(device=d) for d in devices if d.type == "cuda"}
            for batch in batches:
                staged, events = [], []
                for a in batch:
                    parts = split(a) if sharding is not None else [np.asarray(a)]
                    out = []
                    for part, dev in zip(parts, devices):
                        side = sides.get(dev)
                        if side is None:
                            out.append(torch.as_tensor(part))
                            continue
                        with torch.cuda.stream(side):
                            host = torch.from_numpy(np.ascontiguousarray(part)).pin_memory()
                            out.append(host.to(dev, non_blocking=True))
                            ready = torch.cuda.Event()
                            ready.record(side)
                        events.append((dev, ready, out[-1]))
                    staged.append(out if sharding is not None else out[0])
                if not _put_or_stop(q, stop, (tuple(staged), events)):
                    return
        except BaseException as e:  # raised again on the consumer's thread
            errors.append(e)
        _put_or_stop(q, stop, done)

    thread = threading.Thread(target=producer, daemon=True, name="prefetch_to_device")
    thread.start()
    try:
        while True:
            item = q.get()
            if item is done:
                if errors:
                    raise errors[0]
                return
            staged, events = item
            for dev, ready, t in events:
                stream = torch.cuda.current_stream(dev)
                stream.wait_event(ready)
                t.record_stream(stream)
            yield staged
    finally:
        stop.set()
