"""Skill assessment and step recognition inference (BASELINE configs 3-4).

Counterpart of `sais_tpu/infer/skill.py`:

- `SkillAssessor`: EASE-domain skill probabilities over annotated stitch
  segments with frame-importance scores and CLS attention maps — the
  artifacts the reference exports per inference phase (train.py:113-121:
  reps_and_labels_<ph>, attention_<ph>, importance_<ph>).  One batch-1
  forward per (segment, TTA offset) on the card (unless `device='cpu'`),
  each padded to its frame bucket as in the JAX package; windows of 512
  tokens or more (or any, with use_flash) take K2.
- `StepRecognizer`: 10 s / 5 s sliding windows over a whole case video
  (prepare_dataset.py:459-486), decoded by a `GestureDecoder` built with
  `data.tasks.step_window_config`.

Both take and return plain rows instead of pandas DataFrames (the card's
machine has no pandas); `infer.postprocess.write_rows_csv` writes the file
the JAX package's `df.to_csv` writes.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from sais_tpu_torch import DeviceLike, resolve_device
from sais_tpu_torch.config import VUA_FPS_TABLE, PipelineConfig
from sais_tpu_torch.data.tasks import (policy_indices, race_window,
                                       step_window_manifest)
from sais_tpu_torch.infer.pipeline import GestureDecoder, to_device
from sais_tpu_torch.infer.postprocess import Row
from sais_tpu_torch.models.full_model import FullModel, prototypes_forward
from sais_tpu_torch.models.heads import prototype_probs


class SkillAssessor:
    """Per-segment skill inference with importance + attention export."""

    def __init__(self, model: FullModel, prototypes: torch.Tensor,
                 cfg: PipelineConfig,
                 frame_buckets: Sequence[int] = (16, 32, 64, 128),
                 device: DeviceLike = None):
        """model, prototypes: one fold, copied to `device` in float32."""
        self.cfg = cfg
        self.buckets = list(frame_buckets)
        self.device = resolve_device(device)
        self.set_fold(model, prototypes)

    def set_fold(self, model: FullModel, prototypes: torch.Tensor) -> None:
        """Swap in another fold's weights (one assessor serves every fold
        of a run)."""
        self.model = copy.deepcopy(model).to(device=self.device,
                                             dtype=torch.float32).eval()
        self.protos = torch.as_tensor(prototypes, dtype=torch.float32).to(
            self.device)

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        # grow beyond the configured buckets (next power of two) instead of
        # clamping, which would not hold the segment
        b = self.buckets[-1]
        while b < n:
            b *= 2
        return b

    def _padded(self, reps: np.ndarray, idx: np.ndarray):
        """(1, 1, bucket, D) features and (1, 1, bucket + 1) mask on the
        device."""
        fb = self._bucket(max(len(idx), 1))
        x = np.zeros((1, 1, fb, reps.shape[1]), np.float32)
        x[0, 0, :len(idx)] = reps[idx]
        mask = np.zeros((1, 1, fb + 1), bool)
        mask[0, 0, len(idx) + 1:] = True
        return to_device(x, self.device), to_device(mask, self.device)

    def assess_segments(self, rgb_reps: np.ndarray,
                        flow_reps: Optional[np.ndarray],
                        segments: Sequence[Row], phase: str = "",
                        videoname: str = "",
                        flow_jump: Optional[int] = None,
                        fps_table=VUA_FPS_TABLE) -> Dict[str, object]:
        """segments: rows with RACE + the per-RACE frame columns
        (preferred — reference-exact windows/strides via
        data.skill.skill_segment_indices, incl. the AFB_inference
        Needle-Handling stride-120 low-pass) or StartFrame/EndFrame.

        phase selects the sampling policy AND the flow jump
        (prepare_dataset.py:2239-2249 — fixed tables for Gronau/HMH/Lab/
        AFB, the row's RGB stride for the no-branch phases, the VUA fps
        table otherwise); an explicit flow_jump overrides.

        Returns per-TTA reps/probs ({offset index: [per segment]}) plus
        per-segment attention and importance scores from the first TTA
        offset, trimmed to the real frames (perform_training.py:177-185's
        CLS-drop and length trim): the dense encoder's full (f+1, f+1)
        matrix (train.py:117 attention_<ph> layout), or the CLS-query row
        (f+1,) on the flash path."""
        from sais_tpu_torch.data.skill import (RACE_FRAME_COLUMNS,
                                               _flow_jump, _skill_policy,
                                               skill_segment_indices)
        mcfg = self.cfg.model
        if flow_reps is None and "Flow" in mcfg.modalities:
            raise ValueError(
                f"model modalities={mcfg.modalities!r} require flow "
                "representations but none were supplied (flow store "
                "missing?); extract flow or assess with -mod RGB")
        use_rgb = mcfg.modalities in ("RGB", "RGB-Flow")
        use_flow = flow_reps is not None and mcfg.modalities != "RGB"
        out = {"reps": {}, "probs": {}, "attention": [], "importance": []}
        for row in segments:
            policy = _skill_policy(row["RACE"], phase)
            use_race_cols = all(c in row
                                for c in RACE_FRAME_COLUMNS[row["RACE"]])
            if not use_race_cols:
                s, e = race_window(int(row["StartFrame"]),
                                   int(row["EndFrame"]), row["RACE"])
            for ti, off in enumerate(policy.tta_offsets):
                idx = (skill_segment_indices(row, phase, off)
                       if use_race_cols else policy_indices(s, e, policy,
                                                            off))
                f = len(idx)
                rgb = mask = flow = flow_mask = None
                if use_rgb:
                    rgb, mask = self._padded(rgb_reps, idx)
                if use_flow:
                    # EASE semantics (prepare_dataset.py:2250-2252):
                    # unique(idx // jump), NOT bounds-clipped (the
                    # reference raises on out-of-range flow rows)
                    stride = int(idx[1] - idx[0]) if len(idx) > 1 else 1
                    jump = (flow_jump if flow_jump is not None
                            else _flow_jump(videoname, fps_table, phase,
                                            rgb_stride=stride))
                    flow, flow_mask = self._padded(flow_reps,
                                                   np.unique(idx // jump))
                with torch.inference_mode():
                    res = prototypes_forward(self.model, mcfg, rgb, mask,
                                             flow, flow_mask)
                    probs = prototype_probs(res.video_rep, self.protos)
                out["reps"].setdefault(ti, []).append(
                    res.video_rep[0].cpu().numpy())
                out["probs"].setdefault(ti, []).append(
                    probs[0].cpu().numpy())
                if ti == 0:
                    # attention and importance from the first TTA augment
                    # only (prepare_model.py:313-314)
                    attn = res.attn[0, :f + 1]
                    if res.attn.dim() == 3:
                        attn = attn[:, :f + 1]
                    out["attention"].append(attn.cpu().numpy())
                    if res.importances is not None:
                        # drop the CLS slot, trim to xlen
                        # (perform_training.py:182)
                        out["importance"].append(
                            res.importances[0, 0, 1:f + 1, 0].cpu().numpy())
        return out


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
