"""Globally shuffled frame batches from many sequential decode sources.

Own copy of `sais_tpu/io/shuffle_stream.py` (host code, no JAX in it).

The reference pre-trains over a globally SHUFFLED index of frame JPEGs
with 10 DataLoader workers (dino-main/main_dino.py:351-359:
DistributedSampler(shuffle=True), num_workers=10).  Sequential per-video
batches — 64 consecutive frames are two seconds of one camera — are far
from i.i.d. and bias every batch-level statistic in DINO (the teacher
center update most of all), and a single decode stream leaves the step
decode-bound on multi-core hosts.

Video containers do not allow cheap random access (a per-frame seek
re-decodes the GOP), so an exact index shuffle over mp4s would be
decode-bound by seeking.  This loader keeps each source sequential
(fast) and approximates the global shuffle with a bounded reservoir:

  N worker threads decode DIFFERENT sources concurrently
    -> bounded frame queue (backpressure = bounded host RAM)
    -> per-resolution shuffle buffers
    -> batches drawn uniformly at random from a buffer.

Each frame is yielded exactly once per epoch.  Frames batch only with
same-resolution frames (no resampling — mixed-resolution datasets act as
independent shuffle domains, matching the reference where per-hospital
datasets are single-resolution).  With buffer_frames >= the dataset size
this degenerates to an exact uniform shuffle.
"""

from __future__ import annotations

import queue
import random
import threading
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

FrameSource = Callable[[], Iterator[np.ndarray]]


class FrameShuffleStream:
    """One epoch of shuffled frame batches over `sources`.

    sources: callables returning an iterator of (H, W, 3) uint8 frames —
    one per video/frame-dir.  transform: optional per-frame host
    function applied on the worker thread (e.g. the SurgDataset border
    crop); it runs N-way parallel since cv2/numpy release the GIL.
    """

    def __init__(self, sources: Sequence[FrameSource],
                 batch_size: int,
                 buffer_frames: int = 1024,
                 workers: int = 4,
                 seed: int = 0,
                 transform: Optional[Callable[[np.ndarray],
                                              np.ndarray]] = None):
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self.sources = list(sources)
        self.batch_size = batch_size
        self.buffer_frames = max(buffer_frames, batch_size)
        self.workers = max(1, min(workers, len(self.sources) or 1))
        self.rng = random.Random(seed)
        self.transform = transform
        self._q: "queue.Queue[Optional[np.ndarray]]" = queue.Queue(
            maxsize=2 * self.workers * max(batch_size // self.workers, 1))
        self._next_source = 0
        self._source_lock = threading.Lock()
        self._stop = threading.Event()
        self._errors: List[BaseException] = []
        self._threads: List[threading.Thread] = []

    # ---------------------------------------------------------------- workers

    def _claim(self) -> Optional[FrameSource]:
        with self._source_lock:
            if self._next_source >= len(self.sources):
                return None
            src = self.sources[self._next_source]
            self._next_source += 1
            return src

    def _put(self, item) -> bool:
        """Bounded put that aborts when the consumer stopped early."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self) -> None:
        try:
            while not self._stop.is_set():
                src = self._claim()
                if src is None:
                    return
                for frame in src():
                    if self.transform is not None:
                        frame = self.transform(frame)
                    if not self._put(np.ascontiguousarray(frame)):
                        return
        except BaseException as e:   # surfaced by the consumer; a silent
            self._errors.append(e)   # worker death must not look like EOF
        finally:
            self._put(None)          # per-worker end-of-stream marker

    # --------------------------------------------------------------- consumer

    def batches(self, drop_last: bool = True) -> Iterator[np.ndarray]:
        """Yield (batch_size, H, W, 3) uint8 batches; one pass over every
        source.  drop_last drops per-resolution tails shorter than
        batch_size (the reference loader's drop_last over the shuffled
        global index)."""
        if self._threads or self._next_source:
            raise RuntimeError("FrameShuffleStream is single-pass; build a "
                               "fresh instance per epoch")
        for _ in range(self.workers):
            t = threading.Thread(target=self._worker, daemon=True)
            t.start()
            self._threads.append(t)
        buckets: Dict[Tuple[int, ...], List[np.ndarray]] = {}
        buffered = 0
        live = self.workers
        try:
            while live:
                item = self._q.get()
                if self._errors:
                    # surface a worker's decode failure within one queue
                    # round trip — waiting for the remaining workers to
                    # drain every source could hide it for hours
                    raise self._errors[0]
                if item is None:
                    live -= 1
                    continue
                buckets.setdefault(item.shape, []).append(item)
                buffered += 1
                if buffered < self.buffer_frames:
                    continue
                ready = [b for b in buckets.values()
                         if len(b) >= self.batch_size]
                if not ready:
                    # every resolution bucket is still sub-batch: let the
                    # reservoir grow past the soft cap rather than emit a
                    # partial batch mid-stream (the trainer's steps are
                    # shaped for whole batches).  Overshoot is bounded by
                    # n_resolutions * (batch_size - 1) frames.
                    continue
                # weight by size: uniform over buffered frames
                bucket = self.rng.choices(
                    ready, weights=[len(b) for b in ready])[0]
                yield self._draw(bucket)
                buffered = sum(len(b) for b in buckets.values())
            if self._errors:
                raise self._errors[0]
            # drain: full batches first, then tails
            for bucket in buckets.values():
                while len(bucket) >= self.batch_size:
                    yield self._draw(bucket)
            if not drop_last:
                for bucket in buckets.values():
                    if bucket:
                        yield self._draw(bucket)
        finally:
            self.close()

    def _draw(self, bucket: List[np.ndarray]) -> np.ndarray:
        n = min(self.batch_size, len(bucket))
        # draw without replacement; swap-pop keeps removal O(1)
        out = []
        for _ in range(n):
            i = self.rng.randrange(len(bucket))
            bucket[i], bucket[-1] = bucket[-1], bucket[i]
            out.append(bucket.pop())
        return np.stack(out)

    def close(self) -> None:
        """Stop workers (early consumer exit) and join them; safe to call
        twice.  Without the drain a worker blocked in q.put would leak
        with its open decoder (see infer.pipeline._reap_producer)."""
        self._stop.set()
        for t in self._threads:
            while t.is_alive():
                try:
                    self._q.get(timeout=0.05)
                except queue.Empty:
                    pass
            t.join()
        self._threads = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
