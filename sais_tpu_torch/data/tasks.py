"""Step-recognition windows (VUA_EASE_Stitch USC_inference,
prepare_dataset.py:469-486): 10 s windows, 5 s hop over the whole video.

Own copy of the step functions of `sais_tpu/data/tasks.py` (the port
imports nothing of the JAX package).  Its skill and stitch sampling
policies come with the `assess` slice.
"""

from __future__ import annotations

import numpy as np

from sais_tpu_torch.config import WindowConfig
from sais_tpu_torch.data.windows import WindowManifest


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
