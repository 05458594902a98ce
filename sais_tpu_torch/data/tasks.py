"""Task-specific sampling policies: skill (EASE), gestures, steps.

Own copy of `sais_tpu/data/tasks.py`.  The reference hardcodes per-task
frame-index policies inside getData; this module names them:

- Skill / EASE (VUA_EASE, prepare_dataset.py:2160-2212):
  RACE-specific windows over annotated stitch phases:
    Needle Withdrawal: full span, stride = span // 10;
    Needle Handling:   drop the final 20% of frames, stride 10
                       (AFB inference uses stride 120 as a low-pass);
    Needle Driving:    drop the final 20% of frames, stride 10.
  TTA offsets +0/+3/+6 shift BOTH ends (indices2 = arange(start+3, end+3),
  prepare_dataset.py:2195-2198) — unlike gestures where the end is fixed.
- Gestures (Custom/NS, prepare_dataset.py:2642-2656): span // 10 stride,
  TTA shifts the start only.
- Steps (VUA_EASE_Stitch USC_inference, prepare_dataset.py:469-486):
  10 s windows, 5 s hop over the whole video.

All functions return host-side numpy indices; negative indices keep the
reference's wrap semantics.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from sais_tpu_torch.config import WindowConfig
from sais_tpu_torch.data.windows import WindowManifest


@dataclasses.dataclass(frozen=True)
class SamplingPolicy:
    """How to subsample frames within a labeled segment."""

    stride: Optional[int] = None        # fixed stride (None -> span-divided)
    stride_divisor: int = 10            # used when stride is None
    drop_tail_frac: float = 0.0         # drop this fraction of final frames
    end_trim_frames: int = 0            # drop this many final frames
    # (lo, hi): window is [start+lo, start+hi) IGNORING the end column
    # (the stitch branch's NW windows around the withdrawal start)
    window_around_start: Optional[Tuple[int, int]] = None
    frame_cap: Optional[int] = None     # indices[:cap] (NS_vs_VUA 2000)
    tta_offsets: Sequence[int] = (0, 3, 6)
    tta_shifts_end: bool = False        # True: skill semantics (end+offset)


GESTURE_POLICY = SamplingPolicy()

# VUA_EASE skill branch, val/test/inference (prepare_dataset.py:2173-2198);
# the train arm (:2201-2214) uses the same windows/strides
RACE_POLICIES = {
    "Needle Withdrawal": SamplingPolicy(tta_shifts_end=True),
    "Needle Handling": SamplingPolicy(stride=10, drop_tail_frac=0.20,
                                      tta_shifts_end=True),
    "Needle Driving": SamplingPolicy(stride=10, drop_tail_frac=0.20,
                                     tta_shifts_end=True),
}
# AFB_inference Needle Handling low-pass (prepare_dataset.py:2184-2188)
AFB_HANDLING_POLICY = SamplingPolicy(stride=120, drop_tail_frac=0.20,
                                     tta_shifts_end=True)

# VUA_EASE_Stitch branch — DIFFERENT windows from the skill branch above.
# train and val/test (prepare_dataset.py:2307-2355):
#   NW: [start-40, start+40) stride 10; NH: [start, end-20) stride 10;
#   ND: drop 20% of the span, stride 10
STITCH_TRAIN_POLICIES = {
    "Needle Withdrawal": SamplingPolicy(stride=10, tta_shifts_end=True,
                                        window_around_start=(-40, 40)),
    "Needle Handling": SamplingPolicy(stride=10, end_trim_frames=20,
                                      tta_shifts_end=True),
    "Needle Driving": SamplingPolicy(stride=10, drop_tail_frac=0.20,
                                     tta_shifts_end=True),
}
# non-USC inference (:2329-2344): NW [start, start+60); NH/ND full span
STITCH_INFERENCE_POLICIES = {
    "Needle Withdrawal": SamplingPolicy(stride=10, tta_shifts_end=True,
                                        window_around_start=(0, 60)),
    "Needle Handling": SamplingPolicy(stride=10, tta_shifts_end=True),
    "Needle Driving": SamplingPolicy(stride=10, tta_shifts_end=True),
}
# USC_inference (:2323-2328): full span stride 10 for every race
STITCH_USC_POLICY = SamplingPolicy(stride=10, tta_shifts_end=True)

# NS_vs_VUA (prepare_dataset.py:2424-2438): fixed stride 10, 2000-cap
NS_VS_VUA_POLICY = SamplingPolicy(stride=10, frame_cap=2000,
                                  tta_shifts_end=True)


def race_window(start_frame: int, end_frame: int, race: str = ""
                ) -> Tuple[int, int]:
    """(startIdx, endIdx) in rep-index space: both frame numbers -1
    (prepare_dataset.py:2160-2171).  The RACE-specific COLUMN selection
    (Needle Handling ends at Needle Entry Start, Needle Driving spans
    Entry->Withdrawal) happens in callers via RACE_FRAME_COLUMNS; `race`
    is accepted for call-site readability only."""
    return start_frame - 1, end_frame - 1


def policy_indices(start_idx: int, end_idx: int, policy: SamplingPolicy,
                   tta_offset: int = 0) -> np.ndarray:
    """Frame indices for one segment under a policy + TTA offset."""
    if policy.window_around_start is not None:
        lo, hi = policy.window_around_start
        start, end = start_idx + lo, start_idx + hi
        span = end - start
    else:
        start = start_idx
        span = end_idx - start_idx
        end = end_idx - int(span * policy.drop_tail_frac) \
            - policy.end_trim_frames
    stride = (policy.stride if policy.stride is not None
              else max(span // policy.stride_divisor, 1))
    if policy.tta_shifts_end:
        idx = np.arange(start + tta_offset, end + tta_offset, stride)
    else:
        idx = np.arange(start + tta_offset, end, stride)
    return idx[:policy.frame_cap] if policy.frame_cap else idx


def step_window_manifest(video: str, total_frames: int, fps: float = 20.0,
                         duration_s: float = 10.0, hop_s: float = 5.0
                         ) -> WindowManifest:
    """Step-recognition sliding windows (prepare_dataset.py:469-478)."""
    dur = int(duration_s * fps)
    hop = int(hop_s * fps)
    nsamples = (total_frames - dur) // hop + 1
    starts = np.arange(max(nsamples, 0)) * hop
    return WindowManifest(video, starts, starts + dur)


def step_window_config(fps: float = 20.0) -> WindowConfig:
    """WindowConfig for the 10 s / 5 s step-recognition geometry; index
    subsampling inside each window follows the gesture policy (span//10)."""
    return WindowConfig(duration_s=10.0, hop_s=5.0, fps=fps,
                        flow_jump_factor=int(fps // 2))
