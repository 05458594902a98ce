"""Sliding-window sampling over video feature streams.

Replicates the reference Custom_Gestures geometry exactly:

- window manifest: duration = hop = 0.5 s at 30 fps over every frame of the
  video, nsamples = (total - 15) // 15 + 1 (prepare_dataset.py:1705-1728);
- per-window frame indices: startIdx = StartFrame - 1, endIdx = EndFrame - 1,
  stride = span // 10, indices = arange(startIdx, endIdx, stride) with TTA
  start offsets +0 / +3 / +6 (prepare_dataset.py:2642-2651).  The first
  window therefore starts at index -1, which numpy wraps to the LAST frame —
  an off-by-one the reference inherits and its checkpoints were trained
  with; preserved verbatim (SURVEY.md section 7 'off-by-one conventions');
- flow indices: unique(frame_index // 15) filtered to < nflows
  (prepare_dataset.py:2663-2669); -1 // 15 = -1 likewise wraps.

All index math is host-side numpy.  Own copy of `sais_tpu/data/windows.py`
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from sais_tpu_torch.config import WindowConfig


@dataclasses.dataclass(frozen=True)
class WindowManifest:
    """All sliding windows for one video."""

    video: str
    start_frames: np.ndarray  # (W,) int — reference 'StartFrame'
    end_frames: np.ndarray    # (W,) int — reference 'EndFrame'

    def __len__(self) -> int:
        return len(self.start_frames)


def build_window_manifest(video: str, total_frames: int,
                          cfg: WindowConfig) -> WindowManifest:
    """Sliding windows over every frame (prepare_dataset.py:1711-1726)."""
    dur, hop = cfg.duration_frames, cfg.hop_frames
    nsamples = (total_frames - dur) // hop + 1
    starts = np.arange(nsamples) * hop
    return WindowManifest(video, starts, starts + dur)


def window_frame_indices(manifest: WindowManifest, cfg: WindowConfig,
                         tta_offset: int) -> np.ndarray:
    """Frame indices for every window at one TTA offset -> (W, F) int array.

    F is constant across windows because span and stride are constant:
    F = ceil((span - offset) / stride).
    """
    starts = manifest.start_frames - 1
    ends = manifest.end_frames - 1
    span = int(ends[0] - starts[0])
    stride = max(span // cfg.stride_divisor, 1)
    offsets = np.arange(tta_offset, span, stride)
    return starts[:, None] + offsets[None, :]


def flow_indices_for(frame_indices: np.ndarray, nflows: int,
                     cfg: WindowConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Flow-rep indices per window with validity mask.

    Reference (prepare_dataset.py:2663-2669): floor-divide frame indices by
    the flow jump factor, unique them, drop those >= nflows.  Negative
    indices (from the -1 window start) survive and wrap, as in numpy.
    Returns (indices (W, Fmax), valid (W, Fmax)) where Fmax is the largest
    per-window count; invalid slots repeat the first valid index.
    """
    jf = cfg.flow_jump_factor
    per_window: List[np.ndarray] = []
    for row in frame_indices:
        u = np.unique(row // jf)  # np.unique sorts, matching the reference
        u = u[u < nflows]
        per_window.append(u)
    fmax = max((len(u) for u in per_window), default=0)
    fmax = max(fmax, 1)
    w = len(per_window)
    idx = np.zeros((w, fmax), dtype=np.int64)
    valid = np.zeros((w, fmax), dtype=bool)
    for i, u in enumerate(per_window):
        n = len(u)
        if n:
            idx[i, :n] = u
            idx[i, n:] = u[0]
            valid[i, :n] = True
    return idx, valid


def gather_reps(video_reps: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """(N, D) features + (W, F) indices -> (W, F, D) with python negative-
    index wrap semantics (the reference's `video_reps[indices, :]`)."""
    return video_reps[indices]


@dataclasses.dataclass(frozen=True)
class TTABatch:
    """Device-ready arrays for one TTA variant of a window batch.

    rgb: (W, 1, F, D); rgb_mask: (W, 1, F+1) bool True=pad;
    flow: (W, 1, Ff, D); flow_mask: (W, 1, Ff+1).
    Snippet dim is 1: each window is a single snippet in the reference
    collator layout (prepare_dataset.py:2661).
    """

    rgb: np.ndarray
    rgb_mask: np.ndarray
    flow: np.ndarray
    flow_mask: np.ndarray


def build_tta_batches(video_reps: np.ndarray, flow_reps: np.ndarray,
                      manifest: WindowManifest, cfg: WindowConfig
                      ) -> List[TTABatch]:
    """Build one device batch per TTA offset for every window of a video."""
    out = []
    for off in cfg.tta_offsets:
        fi = window_frame_indices(manifest, cfg, off)
        rgb = gather_reps(video_reps, fi)[:, None]            # (W,1,F,D)
        w, _, f, _ = rgb.shape
        rgb_mask = np.zeros((w, 1, f + 1), dtype=bool)
        fidx, fvalid = flow_indices_for(fi, len(flow_reps), cfg)
        flow = gather_reps(flow_reps, fidx)[:, None]
        flow = np.where(fvalid[:, None, :, None], flow, 0.0)
        ff = flow.shape[2]
        flow_mask = np.zeros((w, 1, ff + 1), dtype=bool)
        flow_mask[:, 0, 1:] = ~fvalid
        out.append(TTABatch(rgb.astype(np.float32), rgb_mask,
                            flow.astype(np.float32), flow_mask))
    return out


def segment_frame_indices(start_frame: int, end_frame: int,
                          cfg: WindowConfig, tta_offset: int = 0,
                          fixed_stride: Optional[int] = None,
                          cap: Optional[int] = None) -> np.ndarray:
    """Frame indices of one labeled segment on the reps path (train time):
    both ends minus 1 (prepare_dataset.py:2642-2643), stride span //
    stride_divisor (at least 1), start shifted by the TTA offset.
    fixed_stride / cap override the stride and keep the first `cap`
    indices (NS_vs_VUA: jump_size=10 and indices[:2000],
    prepare_dataset.py:2424-2438)."""
    s, e = start_frame - 1, end_frame - 1
    stride = (fixed_stride if fixed_stride is not None
              else max((e - s) // cfg.stride_divisor, 1))
    idx = np.arange(s + tta_offset, e, stride)
    return idx[:cap] if cap else idx
