"""Step recognition over full-length videos (BASELINE config 4).

Counterpart of `StepRecognizer` in `sais_tpu/infer/skill.py`: 10 s / 5 s
sliding windows over a whole case video (prepare_dataset.py:459-486),
decoded by a `GestureDecoder` built with `data.tasks.step_window_config`.
It returns plain rows instead of a pandas DataFrame (the card's machine
has no pandas); `infer.postprocess.write_rows_csv(rows, path,
recognizer.columns)` writes the file the JAX package's `df.to_csv` writes.
`SkillAssessor` waits for the `assess` slice.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from sais_tpu_torch.data.tasks import step_window_manifest
from sais_tpu_torch.infer.pipeline import GestureDecoder
from sais_tpu_torch.infer.postprocess import Row


class StepRecognizer:
    """Sub-phase recognition over long videos via 10 s / 5 s windows."""

    def __init__(self, decoder: GestureDecoder, fps: float = 20.0,
                 class_names: Sequence[str] = ("Needle Handling",
                                               "Needle Driving",
                                               "Needle Withdrawal")):
        """decoder: a GestureDecoder built with the step-task folds and a
        WindowConfig from data.tasks.step_window_config(fps)."""
        self.decoder = decoder
        self.fps = fps
        self.class_names = list(class_names)

    @property
    def columns(self) -> List[str]:
        """The CSV columns, in the JAX package's DataFrame order."""
        return ["Video", "StartFrame", "EndFrame", "Step", *self.class_names]

    def recognize(self, video: str, rgb_reps: np.ndarray,
                  flow_reps: Optional[np.ndarray] = None) -> List[Row]:
        """One row per window: video, frames, argmax step and the
        fold-ensembled probability of every class."""
        wcfg = self.decoder.cfg.window
        if (int(wcfg.duration_s * wcfg.fps) != int(10 * self.fps)
                or wcfg.fps != self.fps):
            raise ValueError(
                "StepRecognizer fps does not match the decoder's window "
                "config — build the GestureDecoder with "
                f"data.tasks.step_window_config({self.fps})")
        probs = self.decoder.window_probs(video, rgb_reps, flow_reps)
        manifest = step_window_manifest(video, len(rgb_reps), self.fps)
        preds = np.argmax(probs, axis=1)
        rows: List[Row] = []
        for i in range(len(manifest)):
            row: Row = {"Video": video,
                        "StartFrame": int(manifest.start_frames[i]),
                        "EndFrame": int(manifest.end_frames[i]),
                        "Step": self.class_names[preds[i]]}
            for c, name in enumerate(self.class_names):
                row[name] = float(probs[i, c])
            rows.append(row)
        return rows
