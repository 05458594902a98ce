"""End-to-end RGB gesture decoding: frames -> DINO features -> windows ->
temporal model + prototypes over 3 TTA offsets and every fold -> gesture
intervals.

Counterpart of `sais_tpu/infer/pipeline.py` (`FeatureExtractor`,
`GestureDecoder`).  Both run on the card unless the caller passes
`device="cpu"`.  Host-to-device copies go through pinned memory with
`non_blocking=True`, and every chunk runs at its exact size: the JAX
package's tail buckets and warm-shape bookkeeping exist for XLA's compiled
shapes, which eager PyTorch does not have.
"""

from __future__ import annotations

import copy
import os
import queue
import threading
from typing import List, Optional, Sequence, Tuple

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
from sais_tpu_torch.models.vit import VisionTransformer, vit_features
from sais_tpu_torch.ops.preprocess import preprocess_batch


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on `device`; a CUDA copy goes from pinned
    memory and does not block the host."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
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


class FeatureExtractor:
    """Batched DINO CLS-feature extraction (extract_representations.py:
    351-378): PIL-exact preprocessing and the ViT, both on the device."""

    def __init__(self, model: VisionTransformer, cfg: PipelineConfig,
                 batch_size: int = 256, device: DeviceLike = None):
        """model: the ViT; a copy is moved to `device` in the compute dtype
        (bf16 -> the fused K1 path, float32 -> the parity path)."""
        self.cfg = cfg
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self.dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                      else torch.float32)
        self.model = copy.deepcopy(model).to(device=self.device,
                                             dtype=self.dtype).eval()

    def features(self, frames_u8: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8 on the device -> (B, D) float32 features."""
        with torch.inference_mode():
            x = preprocess_batch(frames_u8, self.cfg.preprocess, self.dtype)
            return vit_features(self.model, x)

    def extract_array(self, frames_u8: np.ndarray) -> np.ndarray:
        """(N, H, W, 3) uint8 -> (N, D) float32 CLS features."""
        outs = [self.features(to_device(frames_u8[i:i + self.batch_size],
                                        self.device))
                for i in range(0, frames_u8.shape[0], self.batch_size)]
        return self._gather(outs)

    def extract_video(self, video_path: str, prefetch: int = 4) -> np.ndarray:
        """Stream a video: a producer thread decodes batches into a bounded
        queue while the device computes the previous ones."""
        if not os.path.exists(video_path):
            raise FileNotFoundError(video_path)
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
        outs = []
        try:
            while (batch := q.get()) is not None:
                outs.append(self.features(to_device(batch, self.device)))
        finally:
            stop.set()           # the producer abandons the rest on error
            t.join()
        if errors:
            raise errors[0]
        return self._gather(outs)

    def _gather(self, outs: List[torch.Tensor]) -> np.ndarray:
        if not outs:
            return np.zeros((0, self.cfg.vit.embed_dim), np.float32)
        return torch.cat(outs).cpu().numpy()


class GestureDecoder:
    """Sliding-window gesture inference with TTA and fold ensembling and
    post-processing (reference run_experiments.py --inference, then
    process_inference_results.py)."""

    def __init__(self, fold_params: Sequence[Tuple[FullModel, torch.Tensor]],
                 cfg: PipelineConfig, device_batch: int = 512,
                 device: DeviceLike = None):
        """fold_params: per fold, (temporal model, (P, 256) prototypes).
        Copies of both move to `device` in float32."""
        self.cfg = cfg
        self.device_batch = device_batch
        self.device = resolve_device(device)
        self.folds = [
            (copy.deepcopy(m).to(device=self.device,
                                 dtype=torch.float32).eval(),
             torch.as_tensor(p, dtype=torch.float32).to(self.device))
            for m, p in fold_params]

    def _run_batch(self, model: FullModel, protos: torch.Tensor,
                   tta: TTABatch) -> np.ndarray:
        """Chunked execution of one TTA variant -> (W, P) float64 probs."""
        mcfg = self.cfg.model
        use_rgb = mcfg.modalities in ("RGB", "RGB-Flow")
        use_flow = mcfg.modalities in ("Flow", "RGB-Flow")
        outs = []
        with torch.inference_mode():
            for i in range(0, tta.rgb.shape[0], self.device_batch):
                sl = slice(i, i + self.device_batch)

                def dev(a, wanted):
                    return to_device(a[sl], self.device) if wanted else None

                out = prototypes_forward(
                    model, mcfg, dev(tta.rgb, use_rgb),
                    dev(tta.rgb_mask, use_rgb), dev(tta.flow, use_flow),
                    dev(tta.flow_mask, use_flow))
                outs.append(prototype_probs(out.video_rep, protos))
        return torch.cat(outs).cpu().numpy().astype(np.float64)

    def _check_flow(self, rgb_reps: np.ndarray,
                    flow_reps: Optional[np.ndarray]) -> np.ndarray:
        """Refuse to make up a zero flow stream when Flow contributes."""
        if flow_reps is None:
            if "Flow" in self.cfg.model.modalities:
                raise ValueError(
                    f"model modalities={self.cfg.model.modalities!r} need "
                    "flow representations but none were given; decode with "
                    "-mod RGB")
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
