"""End-to-end gesture decoding: frames -> DINO features (and, for the flow
stream, RAFT flow over frame pairs -> rendered flow -> DINO features) ->
windows -> temporal model + prototypes over 3 TTA offsets and every fold
-> gesture intervals.

Counterpart of `sais_tpu/infer/pipeline.py` (`FeatureExtractor`,
`FlowExtractor`, `GestureDecoder`).  All run on the card unless the caller
passes `device="cpu"`.  Host-to-device copies go through pinned memory with
`non_blocking=True`, and every decoder chunk runs at its exact size: the
JAX package's tail buckets and warm-shape bookkeeping exist for XLA's
compiled shapes, which eager PyTorch does not have.  The flow extractor
pads its last pair batch as the JAX package does, so that a video runs
RAFT at one input shape.
"""

from __future__ import annotations

import contextlib
import copy
import os
import queue
import sys
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sais_tpu_torch import DeviceLike, resolve_device
from sais_tpu_torch.config import PipelineConfig
from sais_tpu_torch.data.windows import (TTABatch, build_tta_batches,
                                         build_window_manifest)
from sais_tpu_torch.infer.postprocess import (Row, decode_gesture_intervals,
                                              ensemble_probs)
from sais_tpu_torch.io.video import VideoReader
from sais_tpu_torch.models.full_model import FullModel, prototypes_forward
from sais_tpu_torch.models.heads import prototype_probs
from sais_tpu_torch.models.raft import (RAFT, pad_to_multiple_of_8,
                                        raft_forward, unpad)
from sais_tpu_torch.models.vit import VisionTransformer, vit_features
from sais_tpu_torch.ops.flow_viz import flow_to_rgb_device, flow_to_rgb_uint8
from sais_tpu_torch.ops.preprocess import normalize_batch, preprocess_batch
from sais_tpu_torch.utils import profiling


def _pinned_upload(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Host tensor -> CUDA `device` through pinned memory: the host copy
    (span `sais.extract.pin`), then a copy that does not block the host
    (span `sais.extract.upload`, counting its `h2d_bytes`)."""
    with profiling.span("sais.extract.pin"):
        t = t.pin_memory()
    with profiling.span("sais.extract.upload"):
        profiling.count("h2d_bytes", t.nbytes)
        return t.to(device, non_blocking=True)


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on `device`; a CUDA copy goes from pinned
    memory and does not block the host."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return _pinned_upload(t, device)
    return t.to(device)


def _put_stoppable(q: "queue.Queue", item, stop: threading.Event) -> bool:
    """Bounded put that gives up once the consumer stopped."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


def _reap_producer(t: threading.Thread, q: "queue.Queue",
                   stop: threading.Event) -> None:
    """Stop a bounded-queue producer and join it, also where the consumer
    stopped mid-stream or never started: the producer abandons the rest
    of the video, a put in flight is unblocked by draining, and its
    decoder handle is released with the thread (a long-lived daemon would
    otherwise keep one per failed request)."""
    stop.set()
    while t.is_alive():
        try:
            q.get(timeout=0.1)
        except queue.Empty:
            pass
    t.join()


_END = object()   # the end of a stream's batches


class _HostStream:
    """A running host decode of one video: its producer (the frame pump's
    thread, or an OpenCV thread) is already filling a bounded buffer.
    Opening the decode apart from the device pass lets the serve daemon
    decode request B on the host while request A holds the card.  Always
    close() it: that joins the producer and releases its decoder."""

    def __init__(self, batches, features, close,
                 errors: Optional[List[BaseException]] = None):
        self.batches = batches      # iterator of uint8 frame batches
        self.features = features    # one batch -> features on the device
        self._close = close
        self._errors = errors       # the producer's exception, if any

    def close(self) -> None:
        self._close()

    def raise_if_failed(self) -> None:
        if self._errors:
            raise self._errors[0]


class FeatureExtractor:
    """Batched DINO CLS-feature extraction (extract_representations.py:
    351-378): PIL-exact preprocessing and the ViT, both on the device."""

    def __init__(self, model: VisionTransformer, cfg: PipelineConfig,
                 batch_size: int = 256, device: DeviceLike = None,
                 exact_preprocess: bool = False, mesh: Any = None):
        """model: the ViT; a copy is moved to `device` in the compute dtype
        (bf16 -> the fused K1 path, float32 -> the parity path).

        `extract_video` decodes, crops and resizes on the C++ frame pump's
        thread (`io.native_loader`) and the device only normalizes; where
        the pump cannot be built or opened, it decodes with OpenCV's
        Python binding and preprocesses on the device.
        exact_preprocess: crop, resize and normalize on the host CPU
        (`preprocess_host`), then copy the normalized frames to the
        device, with native decode off, as the JAX package's
        --exact-preprocess route (there through PIL; here the same
        PIL-exact arithmetic in torch on the CPU, and the same float32
        normalize as the device route).

        mesh: frame batches are split over the mesh's ranks (data
        parallelism, JAX's shard_map over every mesh axis): every rank
        decodes the same frames, runs the ViT on its block of each batch,
        and the features are gathered in order on every rank (the caller's
        rank 0 writes them).  The batch rounds down to a multiple of the
        ranks, at least one each, as in JAX (pipeline.py:136-140)."""
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None:
            from sais_tpu_torch.parallel.mesh import mesh_size
            ndev = mesh_size(mesh)
            batch_size = max(ndev, batch_size - batch_size % ndev)
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self.dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                      else torch.float32)
        self.model = copy.deepcopy(model).to(device=self.device,
                                             dtype=self.dtype).eval()
        self.exact_preprocess = exact_preprocess
        self.scatter = None   # see _sharded

    def preprocess_host(self, frames_u8: np.ndarray) -> torch.Tensor:
        """(B, H, W, 3) uint8 on the host -> (B, S, S, 3) normalized
        float32, computed on the host CPU (the --exact-preprocess route)."""
        return preprocess_batch(torch.from_numpy(np.ascontiguousarray(
            frames_u8)), self.cfg.preprocess, torch.float32)

    def _to_device(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type == "cpu" and self.device.type == "cuda":
            return _pinned_upload(x, self.device)
        return x.to(self.device)

    def _sharded(self, owner, method: str, *xs: torch.Tensor
                 ) -> torch.Tensor:
        """owner._block_<method> over the batch (host or device tensors),
        or over this rank's block of it under a mesh, the outputs gathered
        in order (`parallel.mesh.row_blocks`, `gather_rows`).  Host rows
        are copied to the device after the split, so a rank copies its
        block only.
        With `scatter` set (the serve daemon's rank 0, which alone holds
        the batch), scatter(owner, method, blocks, rows) first hands the
        other ranks their blocks, and each of them makes the same call
        through `run_block`."""
        with torch.inference_mode():
            if self.mesh is None:
                return self._run(owner, method, xs)
            from sais_tpu_torch.parallel.mesh import (gather_rows, mesh_rank,
                                                      row_blocks)
            blocks, rows = row_blocks(xs, self.mesh)
            if self.scatter is not None:
                self.scatter(owner, method, blocks, rows)
            return gather_rows(self._run(owner, method,
                                         blocks[mesh_rank(self.mesh)]),
                               self.mesh, rows)

    def _run(self, owner, method: str, xs) -> torch.Tensor:
        return getattr(owner, "_block_" + method)(
            *(self._to_device(x) for x in xs))

    def run_block(self, owner, method: str, block, rows: int) -> None:
        """This rank's part of a sharded call whose batch another rank
        holds (`scatter`): owner._block_<method> over `block`, then the
        gather of every rank's outputs."""
        from sais_tpu_torch.parallel.mesh import gather_rows
        with torch.inference_mode():
            gather_rows(self._run(owner, method, block), self.mesh, rows)

    def features(self, frames_u8: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8 on the host or the device -> (B, D) float32
        features on the device."""
        return self._sharded(self, "features", frames_u8)

    def _block_features(self, f: torch.Tensor) -> torch.Tensor:
        with profiling.span("sais.extract.vit"):
            return vit_features(self.model, preprocess_batch(
                f, self.cfg.preprocess, self.dtype))

    def features_resized(self, frames_u8: torch.Tensor) -> torch.Tensor:
        """(B, S, S, 3) uint8 crops already resized (the frame pump's), on
        the host or the device -> (B, D) float32 features."""
        return self._sharded(self, "features_resized", frames_u8)

    def _block_features_resized(self, f: torch.Tensor) -> torch.Tensor:
        with profiling.span("sais.extract.vit"):
            return vit_features(self.model, normalize_batch(
                f, self.cfg.preprocess, self.dtype))

    def features_normalized(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, S, 3) normalized float32 frames on the host or the
        device -> (B, D) float32 features."""
        return self._sharded(self, "features_normalized", x)

    def _block_features_normalized(self, f: torch.Tensor) -> torch.Tensor:
        with profiling.span("sais.extract.vit"):
            return vit_features(self.model, f.to(self.dtype))

    def _host_batch(self, batch: np.ndarray) -> torch.Tensor:
        """One decoded batch through the route the extractor takes, to
        features on the device."""
        if self.exact_preprocess:
            return self.features_normalized(self.preprocess_host(batch))
        return self.features(torch.from_numpy(np.ascontiguousarray(batch)))

    def extract_array(self, frames_u8: np.ndarray) -> np.ndarray:
        """(N, H, W, 3) uint8 -> (N, D) float32 CLS features."""
        outs = [self._host_batch(frames_u8[i:i + self.batch_size])
                for i in range(0, frames_u8.shape[0], self.batch_size)]
        return self._gather(outs)

    def _pump(self, video_path: str):
        """The native frame pump for the video, or None where it cannot be
        built or opened: only building and constructing it may fall back;
        a decode failure past that point propagates."""
        from sais_tpu_torch.io.native_loader import NativeFramePump
        pre = self.cfg.preprocess
        try:
            return NativeFramePump(video_path, out_size=pre.resize,
                                   crop_h_frac=pre.crop_height_frac,
                                   crop_w_frac=pre.crop_width_frac,
                                   queue_cap=4 * self.batch_size)
        except RuntimeError as e:
            print(f"frame pump: {e}; decoding with OpenCV's Python binding",
                  file=sys.stderr)
            return None

    def open_stream(self, video_path: str, prefetch: int = 4) -> _HostStream:
        """Start the host decode of a video now and return it running: the
        frame pump (at most 4 batches queued), or a producer thread that
        decodes with OpenCV into a queue of `prefetch` batches.  A caller
        that cannot use the device yet (the serve daemon holding request B
        while A decodes) still makes progress on the host;
        `extract_video(stream=...)` later consumes what is buffered."""
        if not os.path.exists(video_path):
            raise FileNotFoundError(video_path)
        pump = None if self.exact_preprocess else self._pump(video_path)
        if pump is not None:
            return _HostStream(
                pump.batches(self.batch_size),
                lambda b: self.features_resized(
                    torch.from_numpy(np.ascontiguousarray(b))),
                pump.close)
        q: "queue.Queue[Optional[np.ndarray]]" = queue.Queue(maxsize=prefetch)
        errors: List[BaseException] = []
        stop = threading.Event()

        def producer():
            try:
                with VideoReader(video_path) as r:
                    for batch in r.batches(self.batch_size):
                        if not _put_stoppable(q, batch, stop):
                            return
            except BaseException as e:   # re-raised by the consumer: a
                errors.append(e)         # decode failure is not an EOF
            finally:
                _put_stoppable(q, None, stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()

        def batches():
            while (batch := q.get()) is not None:
                yield batch

        return _HostStream(batches(), self._host_batch,
                           lambda: _reap_producer(t, q, stop), errors)

    def extract_video(self, video_path: str, prefetch: int = 4,
                      stream: Optional[_HostStream] = None) -> np.ndarray:
        """Stream a video: the frame pump, or a producer thread, decodes
        batches into a bounded queue while the device computes the
        previous ones.  `stream`: a decode of video_path already opened
        by `open_stream`; it is consumed and closed either way.
        Spans: `sais.extract.video` around `next` (the wait for the
        stream's next batch), the upload's, `vit` and `gather`."""
        with profiling.span("sais.extract.video"):
            if stream is None:
                stream = self.open_stream(video_path, prefetch)
            outs = []
            batches = iter(stream.batches)
            try:
                while True:
                    with profiling.span("sais.extract.next"):
                        b = next(batches, _END)
                    if b is _END:
                        break
                    outs.append(stream.features(b))
            finally:
                stream.close()   # the producer abandons the rest on error
            stream.raise_if_failed()
            return self._gather(outs)

    def _gather(self, outs: List[torch.Tensor]) -> np.ndarray:
        if not outs:
            return np.zeros((0, self.cfg.vit.embed_dim), np.float32)
        with profiling.span("sais.extract.gather"):
            return torch.cat(outs).cpu().numpy()


def _save_flow_images(rgb: np.ndarray, out_dir: str, first: int) -> int:
    """The reference's saveFlows layout (extract_representations.py:254-262):
    flows_%08d.jpg numbered by pair index, written with PIL; returns the
    next index."""
    from PIL import Image
    os.makedirs(out_dir, exist_ok=True)
    for i, im in enumerate(rgb):
        Image.fromarray(im).save(os.path.join(out_dir,
                                              f"flows_{first + i:08d}.jpg"))
    return first + len(rgb)


class FlowExtractor:
    """Motion-stream features (reference extract_representations.py
    --optical_flow, then --optical_flow_to_reps, in one pass with no JPEG
    round trip): RAFT over frame pairs (i, i + jump) at stride jump, the
    flow rendered to RGB, then the DINO ViT (K1 on the bf16 path)."""

    def __init__(self, raft: RAFT, vit: VisionTransformer,
                 cfg: PipelineConfig, pair_batch: Optional[int] = None,
                 iters: Optional[int] = None,
                 flow_resize: Optional[Tuple[int, int]] = None,
                 device: DeviceLike = None, mesh: Any = None):
        """pair_batch: RAFT pairs per call (None: `auto_pair_batch`).
        iters: RAFT refinements (default cfg.raft.iters).  flow_resize:
        (H, W) to resize frames to before RAFT, the reference's policy for
        oversized inputs (extract_representations.py:122-123).  The RAFT
        encoders run in bf16 when cfg.compute_dtype is bf16, the rest of
        RAFT in float32 (`models.raft`).  mesh: pair batches split over
        the mesh's ranks, RAFT and the flow ViT on each rank's block (the
        pair batch a multiple of the ranks, JAX's pipeline.py:328)."""
        self.cfg = cfg
        self.mesh = mesh
        self._ndev = 1
        if mesh is not None:
            from sais_tpu_torch.parallel.mesh import mesh_size
            self._ndev = mesh_size(mesh)
            if pair_batch is not None:
                pair_batch = max(self._ndev,
                                 pair_batch - pair_batch % self._ndev)
        self.pair_batch = pair_batch
        self.iters = cfg.raft.iters if iters is None else iters
        self.flow_resize = flow_resize
        self.device = resolve_device(device)
        self.raft = copy.deepcopy(raft).to(self.device).eval()
        self.raft_dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                           else torch.float32)
        self._features = FeatureExtractor(vit, cfg, batch_size=64,
                                          device=self.device, mesh=mesh)
        self.peak_buffered_pairs = 0

    def auto_pair_batch(self, height: int, width: int) -> int:
        """The caller's pair_batch, else the JAX package's rule: as many
        pairs as keep the float32 level-0 correlation volume under about
        2 GB, at most 8, per rank of a mesh.  The cap and the limit were
        measured on a TPU; they stay so that both packages batch alike."""
        if self.pair_batch is not None:
            return self.pair_batch
        hw8 = (height // 8) * (width // 8)
        return max(1, min(8, int(2e9 / max(hw8 * hw8 * 4, 1)))) * self._ndev

    def _resize(self, frame: np.ndarray) -> np.ndarray:
        if self.flow_resize is None:
            return frame
        import cv2
        h, w = self.flow_resize
        return cv2.resize(frame, (w, h))

    def flow(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8 frame pairs on the device -> (B, H, W, 2)
        float32 flow (padded to multiples of 8 for RAFT, cut back); under a
        mesh each rank runs its block of the pairs."""
        return self._features._sharded(self, "flow", a, b)

    def _block_flow(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        p1, pads = pad_to_multiple_of_8(a.float())
        p2, _ = pad_to_multiple_of_8(b.float())
        return unpad(raft_forward(self.raft, p1, p2, self.cfg.raft,
                                  self.iters, self.raft_dtype), pads)

    def fused(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """RAFT, the device renderer, the PIL-exact preprocess and the ViT,
        all on the device: (B, D) float32 flow reps (each rank's block of
        the pairs under a mesh)."""
        return self._features._sharded(self, "fused", a, b)

    def _block_fused(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        feats = self._features
        return vit_features(feats.model, preprocess_batch(
            flow_to_rgb_device(self._block_flow(a, b)), self.cfg.preprocess,
            feats.dtype))

    def _pad_tail(self, a: np.ndarray, b: np.ndarray, size: int):
        """Pad a short chunk to `size` pairs with its last pair, so that a
        video runs RAFT at one input shape."""
        n = len(a)
        if n < size:
            a = np.concatenate([a, np.repeat(a[-1:], size - n, axis=0)])
            b = np.concatenate([b, np.repeat(b[-1:], size - n, axis=0)])
        return (torch.from_numpy(np.ascontiguousarray(a)),
                torch.from_numpy(np.ascontiguousarray(b)), n)

    def flow_fields(self, frames: np.ndarray) -> np.ndarray:
        """(N, H, W, 3) uint8 -> (P, H, W, 2) flow of the pairs (i, i +
        jump) at stride jump (generate_paths.py:43-54)."""
        jump = self.cfg.window.flow_jump_factor
        n = frames.shape[0]
        if self.flow_resize is not None:
            frames = np.stack([self._resize(f) for f in frames])
        starts = np.arange(0, n - jump, jump)
        pair_batch = self.auto_pair_batch(frames.shape[1], frames.shape[2])
        flows = []
        for i in range(0, len(starts), pair_batch):
            chunk = starts[i:i + pair_batch]
            a, b, k = self._pad_tail(frames[chunk], frames[chunk + jump],
                                     pair_batch)
            flows.append(self.flow(a, b)[:k].cpu())
        if not flows:
            return np.zeros((0,) + frames.shape[1:3] + (2,), np.float32)
        return torch.cat(flows).numpy()

    def extract(self, frames: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(N, H, W, 3) uint8 -> (flow reps (P, D), flow RGB uint8 (P, H, W,
        3)), rendered on the host."""
        fields = self.flow_fields(frames)
        rgb = (np.stack([flow_to_rgb_uint8(f) for f in fields]) if len(fields)
               else np.zeros((0,) + fields.shape[1:3] + (3,), np.uint8))
        return self._features.extract_array(rgb), rgb

    def extract_video(self, video_path: Optional[str], prefetch: int = 8,
                      frame_source=None,
                      save_flow_dir: Optional[str] = None) -> np.ndarray:
        """Stream a video: decode -> RAFT -> flow RGB -> DINO reps, without
        holding the video in host memory.  A producer thread keeps every
        jump-th frame, and consecutive kept frames are exactly the pairs;
        they pass through a bounded queue, so at most prefetch + pair_batch
        pairs are buffered whatever the length.

        Without save_flow_dir the whole chunk stays on the device (`fused`);
        with it, the flow comes to the host, is rendered there and written
        as flows_%08d.jpg, and the images go through the ViT.
        frame_source: an iterator of (H, W, 3) uint8 frames in place of
        decoding video_path."""
        if frame_source is None and not os.path.exists(video_path):
            raise FileNotFoundError(video_path)
        jump = self.cfg.window.flow_jump_factor
        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        errors: List[BaseException] = []
        stop = threading.Event()

        def producer():
            prev = None
            try:
                with contextlib.ExitStack() as stack:
                    frames = (iter(frame_source) if frame_source is not None
                              else stack.enter_context(
                                  VideoReader(video_path)).frames())
                    for i, frame in enumerate(frames):
                        if i % jump:
                            continue
                        frame = self._resize(frame)
                        if prev is not None and not _put_stoppable(
                                q, (prev, frame), stop):
                            return
                        prev = frame
            except BaseException as e:   # re-raised by the consumer: a
                errors.append(e)         # decode failure is not an EOF
            finally:
                _put_stoppable(q, None, stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        reps: List[torch.Tensor] = []
        n_saved = 0
        self.peak_buffered_pairs = 0
        pair_batch = self.pair_batch
        buf: List[Tuple[np.ndarray, np.ndarray]] = []
        done = False
        try:
            while not done:
                item = q.get()
                if item is None:
                    done = True
                else:
                    buf.append(item)
                if not buf or not (done or len(buf) == (pair_batch or 8)):
                    continue
                self.peak_buffered_pairs = max(self.peak_buffered_pairs,
                                               len(buf))
                i1 = np.stack([p[0] for p in buf])
                i2 = np.stack([p[1] for p in buf])
                buf = []
                if pair_batch is None:
                    pair_batch = self.auto_pair_batch(i1.shape[1],
                                                      i1.shape[2])
                for s in range(0, len(i1), pair_batch):
                    a, b, n = self._pad_tail(i1[s:s + pair_batch],
                                             i2[s:s + pair_batch], pair_batch)
                    if save_flow_dir is None:
                        reps.append(self.fused(a, b)[:n])
                        continue
                    rgb = np.stack([flow_to_rgb_uint8(f) for f in
                                    self.flow(a, b)[:n].cpu().numpy()])
                    n_saved = _save_flow_images(rgb, save_flow_dir, n_saved)
                    reps.append(torch.from_numpy(
                        self._features.extract_array(rgb)))
        finally:
            stop.set()           # the producer abandons the rest on error
            t.join()
        if errors:
            raise errors[0]
        if not reps:
            return np.zeros((0, self.cfg.vit.embed_dim), np.float32)
        return torch.cat([r.cpu() for r in reps]).numpy()


class GestureDecoder:
    """Sliding-window gesture inference with TTA and fold ensembling and
    post-processing (reference run_experiments.py --inference, then
    process_inference_results.py)."""

    def __init__(self, fold_params: Sequence[Tuple[FullModel, torch.Tensor]],
                 cfg: PipelineConfig, device_batch: int = 512,
                 device: DeviceLike = None, seq_mesh: Any = None):
        """fold_params: per fold, (temporal model, (P, 256) prototypes).
        Copies of both move to `device` in float32.

        seq_mesh: a mesh with a 'seq' axis: the temporal encoder runs as
        ring attention over it (`parallel.sequence`), each window's time
        axis split over its ranks; the attention artifact is then the CLS
        row, as on the flash path."""
        self.encoder_fn = None
        if seq_mesh is not None:
            if cfg.model.temporal.use_flash is False:
                # --flash off promises the reference's full (L, L)
                # attention artifact, which the ring never forms
                raise ValueError(
                    "seq_mesh with use_flash=False (--flash off): "
                    "sequence parallelism only exports the CLS-row "
                    "attention artifact, which --flash off promises not "
                    "to do; drop --flash off or --seq-parallel")
            from sais_tpu_torch.parallel.sequence import ring_encoder_fn
            self.encoder_fn = ring_encoder_fn(seq_mesh, cfg.model.temporal)
        self.cfg = cfg
        self.device_batch = device_batch
        self.device = resolve_device(device)
        self.folds = [
            (copy.deepcopy(m).to(device=self.device,
                                 dtype=torch.float32).eval(),
             torch.as_tensor(p, dtype=torch.float32).to(self.device))
            for m, p in fold_params]

    def _chunks(self, model: FullModel, protos: torch.Tensor,
                tta: TTABatch):
        """Yield (PrototypesOutput, probs) per device chunk of one TTA
        variant, in window order."""
        mcfg = self.cfg.model
        use_rgb = mcfg.modalities in ("RGB", "RGB-Flow")
        use_flow = mcfg.modalities in ("Flow", "RGB-Flow")
        with torch.inference_mode():
            for i in range(0, tta.rgb.shape[0], self.device_batch):
                sl = slice(i, i + self.device_batch)

                def dev(a, wanted):
                    return to_device(a[sl], self.device) if wanted else None

                out = prototypes_forward(
                    model, mcfg, dev(tta.rgb, use_rgb),
                    dev(tta.rgb_mask, use_rgb), dev(tta.flow, use_flow),
                    dev(tta.flow_mask, use_flow),
                    encoder_fn=self.encoder_fn)
                yield out, prototype_probs(out.video_rep, protos)

    def _run_batch(self, model: FullModel, protos: torch.Tensor,
                   tta: TTABatch) -> np.ndarray:
        """Chunked execution of one TTA variant -> (W, P) float64 probs."""
        probs = [p for _, p in self._chunks(model, protos, tta)]
        return torch.cat(probs).cpu().numpy().astype(np.float64)

    def _check_flow(self, rgb_reps: np.ndarray,
                    flow_reps: Optional[np.ndarray]) -> np.ndarray:
        """Refuse to make up a zero flow stream when Flow contributes."""
        if flow_reps is None:
            if "Flow" in self.cfg.model.modalities:
                raise ValueError(
                    f"model modalities={self.cfg.model.modalities!r} require "
                    "flow representations but none were supplied (flow store "
                    "missing?); run flow extraction or decode with -mod RGB")
            return np.zeros((1, rgb_reps.shape[1]), np.float32)
        return flow_reps

    def window_probs(self, video: str, rgb_reps: np.ndarray,
                     flow_reps: Optional[np.ndarray] = None) -> np.ndarray:
        """TTA-then-fold averaged per-window probabilities (W, P)."""
        manifest = build_window_manifest(video, len(rgb_reps),
                                         self.cfg.window)
        if len(manifest) == 0:   # video shorter than one window
            return np.zeros((0, self.cfg.model.nclasses), np.float64)
        flow_reps = self._check_flow(rgb_reps, flow_reps)
        tta_batches = build_tta_batches(rgb_reps, flow_reps, manifest,
                                        self.cfg.window)
        return ensemble_probs([[self._run_batch(m, p, t) for t in tta_batches]
                               for m, p in self.folds])

    def decode(self, video: str, rgb_reps: np.ndarray,
               flow_reps: Optional[np.ndarray] = None) -> List[Row]:
        """Per-video window decode -> merged gesture-interval rows."""
        manifest = build_window_manifest(video, len(rgb_reps),
                                         self.cfg.window)
        probs = self.window_probs(video, rgb_reps, flow_reps)
        if len(probs) == 0:
            return []
        return decode_gesture_intervals(probs, manifest.start_frames,
                                        manifest.end_frames, video,
                                        self.cfg.postprocess)

    def inference_artifacts(self, video: str, rgb_reps: np.ndarray,
                            flow_reps: Optional[np.ndarray] = None,
                            fold: int = 0) -> Dict[str, object]:
        """Per-window reps and probabilities of every TTA augment plus the
        first augment's attention, the artifacts the reference keeps per
        inference phase (train.py:113-119).  The attention is the dense
        encoder's (W, L, L) matrices, or the (W, L) CLS-query rows when
        the windows take K2 (the only rows SAIS consumes,
        prepare_model.py:221); force use_flash=False for full matrices."""
        manifest = build_window_manifest(video, len(rgb_reps),
                                         self.cfg.window)
        if len(manifest) == 0:   # video shorter than one window
            return {"reps": {}, "probs": {}, "attention": None,
                    "start_frames": manifest.start_frames,
                    "end_frames": manifest.end_frames, "videonames": []}
        flow_reps = self._check_flow(rgb_reps, flow_reps)
        tta_batches = build_tta_batches(rgb_reps, flow_reps, manifest,
                                        self.cfg.window)
        model, protos = self.folds[fold]
        reps: Dict[int, np.ndarray] = {}
        probs: Dict[int, np.ndarray] = {}
        attention = None

        def gather(ts):
            return torch.cat(ts).cpu().numpy()

        for ti, tta in enumerate(tta_batches):
            chunks = list(self._chunks(model, protos, tta))
            reps[ti] = gather([o.video_rep for o, _ in chunks])
            probs[ti] = gather([p for _, p in chunks])
            if ti == 0:   # attention from the first augment only
                attention = gather([o.attn for o, _ in chunks])
        return {"reps": reps, "probs": probs, "attention": attention,
                "start_frames": manifest.start_frames,
                "end_frames": manifest.end_frames,
                "videonames": [video] * len(manifest)}
