"""Gesture-prediction post-processing -> results CSV, without pandas.

Own copy of `sais_tpu/infer/postprocess.py`, replicating
process_inference_results.py:201-258:

1. mean probabilities over the 3 TTA augments (:218), then over folds
   (:224-228);
2. entropy -sum(p log p) and the threshold prediction: the last class iff
   its probability exceeds 0.515 (:130-137, 230);
3. per predicted gesture: drop rows with entropy > 0.66 (:244), split into
   intervals where the window-INDEX gap exceeds `merge_gap_s` (:139-169),
   average the probabilities per interval and predict again by argmax
   (:171-183);
4. frames -> HH:MM:SS at 30 fps (:185-197);
5. write results/Custom_inference_gestures.csv (:258) with the columns,
   column order and leading index column of pandas' `DataFrame.to_csv`
   (`write_rows_csv`, which also writes the steps and skill CSVs).
"""

from __future__ import annotations

import csv
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from sais_tpu_torch.config import PostprocessConfig

Row = Dict[object, object]


def ensemble_probs(fold_tta_probs: Sequence[Sequence[np.ndarray]]) -> np.ndarray:
    """[(fold)][(tta)] (W, P) prob arrays -> (W, P) TTA-then-fold mean."""
    per_fold = [np.mean(np.stack(tta, 0), 0) for tta in fold_tta_probs]
    return np.mean(np.stack(per_fold, 0), 0)


def prediction_entropy(probs: np.ndarray) -> np.ndarray:
    return -np.sum(probs * np.log(probs), axis=-1)


def threshold_preds(probs: np.ndarray, threshold: Optional[float],
                    class_names: Sequence[str]) -> np.ndarray:
    """getPreds (:130-137): with a threshold the LAST class wins iff its
    probability exceeds it; otherwise argmax."""
    if threshold is None:
        idx = np.argmax(probs, axis=-1)
    else:
        idx = (probs[:, -1] > threshold).astype(np.int64)
    return np.asarray(class_names)[idx]


def split_intervals(indices: np.ndarray, gap: int) -> List[Tuple[int, int]]:
    """groupPredictionIntervals (:139-169): inclusive (start, end) pairs of
    the sorted surviving window indices.  Keeps the reference's edge case:
    a gap landing on the final row emits both the closed interval and a
    singleton for the final row."""
    if len(indices) == 0:
        return []
    if len(indices) == 1:
        return [(int(indices[0]), int(indices[0]))]
    out: List[Tuple[int, int]] = []
    start = prev = int(indices[0])
    cum = 0
    for pos in range(1, len(indices)):
        idx = int(indices[pos])
        if idx - prev > gap:
            out.append((start, prev))
            start = idx
            cum = 0
        if pos == len(indices) - 1:
            out.append((idx, idx) if cum == 0 else (start, idx))
        cum += 1
        prev = idx
    return out


def frames_to_time(frames: Sequence[int], fps: int) -> List[str]:
    """FramesToTime (:185-197) -> 'HH:MM:SS'."""
    out = []
    for fr in frames:
        sec = int(fr) // fps
        mn = sec // 60
        hr = (mn // 60) % 60
        out.append(f"{hr:02d}:{mn % 60:02d}:{sec % 60:02d}")
    return out


def gesture_columns(nclasses: int) -> List[object]:
    """Reference column order (:247-255): class probabilities 0..P-1 first."""
    return list(range(nclasses)) + [
        "StartFrame", "EndFrame", "Entropy", "pred", "StartTime", "EndTime",
        "Gesture", "Video", "Path"]


def decode_gesture_intervals(probs: np.ndarray, start_frames: np.ndarray,
                             end_frames: np.ndarray, video: str,
                             cfg: PostprocessConfig) -> List[Row]:
    """Ensembled window probabilities (W, P), aligned with the window
    manifest -> merged gesture intervals, one dict per CSV row with the
    keys in `gesture_columns` order."""
    class_names = list(cfg.class_names)
    ncls = probs.shape[1]
    entropy = prediction_entropy(probs)
    preds = threshold_preds(probs, cfg.decision_threshold, class_names)
    rows: List[Row] = []
    for gesture in class_names:
        keep = (preds == gesture) & (entropy <= cfg.entropy_threshold)
        idx = np.nonzero(keep)[0]
        for s_i, e_i in split_intervals(idx, cfg.merge_gap_s):
            sel = np.arange(s_i, e_i + 1)
            sel = sel[keep[sel]]   # the filtered rows between the endpoints
            mean_probs = probs[sel].mean(axis=0)
            row: Row = {c: float(mean_probs[c]) for c in range(ncls)}
            start, end = int(start_frames[s_i]), int(end_frames[e_i])
            row["StartFrame"] = start
            row["EndFrame"] = end
            row["Entropy"] = float(-np.sum(mean_probs * np.log(mean_probs)))
            # the interval is predicted again by argmax, not the threshold
            # (getGestures calls getPreds with threshold=None, :182)
            row["pred"] = str(threshold_preds(mean_probs[None], None,
                                              class_names)[0])
            row["StartTime"], row["EndTime"] = frames_to_time([start, end],
                                                              cfg.fps)
            row["Gesture"] = gesture
            row["Video"] = video
            row["Path"] = "images/" + video
            rows.append(row)
    return rows


def _cell(value: object) -> object:
    # pandas writes a missing value as an empty cell
    return "" if isinstance(value, float) and math.isnan(value) else value


def write_rows_csv(rows: List[Row], path: str,
                   columns: Optional[Sequence[object]] = None,
                   index: Optional[Sequence[object]] = None) -> None:
    """The file pandas' `DataFrame(rows, index=index).to_csv(path)` writes:
    a header with an empty index label, then each row's label (its number
    when `index` is None) and its values (floats as their shortest
    round-trip repr, NaN as an empty cell).  No rows: the header alone
    when `columns` names them, else '""' (pandas' empty frame)."""
    with open(path, "w", newline="") as f:
        if not rows and columns is None:
            f.write('""\n')
            return
        w = csv.writer(f, lineterminator="\n")
        columns = list(rows[0]) if rows else list(columns)
        labels = range(len(rows)) if index is None else index
        w.writerow([""] + columns)
        for label, row in zip(labels, rows):
            w.writerow([label] + [_cell(row[c]) for c in columns])
