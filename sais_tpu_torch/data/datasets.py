"""Labeled-segment datasets: splits, class balancing, fold semantics.

Own copy of `sais_tpu/data/datasets.py` without pandas (the card's machine
has none).  A segment table is a list of dicts with the columns Video,
StartFrame, EndFrame and Gesture, read from CSV with `read_segments`, which
types each column as pandas' read_csv would (int, then float, else str).
The reference VideoDataset policies (prepare_dataset.py) are kept to the
row and its order:

- fold-seeded video-level splits: random.seed(fold);
  train = random.sample(cases, int(0.7 n)); val = random.sample(train,
  int(0.2 |train|)); train -= val; test = rest (:1647-1658), with the same
  `random` calls and the same set expressions as the JAX package, so the
  order of the resulting lists is the same too;
- class balancing: every class downsampled to the minority count with
  DataFrame.sample(n, replace=False, random_state=0) (:1627-1635), which
  takes the first n of np.random.RandomState(0).permutation(len);
  balance=False still balances val/test (:1664-1666);
- label encoding: sorted class names (LabelEncoder, :2639).
"""

from __future__ import annotations

import csv
import dataclasses
import random
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

Row = Dict[str, Any]


def _typed_column(values: List[str]) -> List[Any]:
    for cast in (int, float):
        try:
            return [cast(v) for v in values]
        except ValueError:
            pass
    return values


def read_segments(path: str) -> List[Row]:
    """A segments CSV -> rows, each column named and typed as
    pandas.read_csv names and types it (an empty header is 'Unnamed: <i>';
    all ints -> int, else all floats -> float, else str)."""
    with open(path, newline="") as f:
        header, *body = list(csv.reader(f))
    names = [h or f"Unnamed: {i}" for i, h in enumerate(header)]
    columns = [_typed_column([r[i] for r in body])
               for i in range(len(names))]
    return [dict(zip(names, values)) for values in zip(*columns)]


def fold_video_split(cases: Sequence[str], fold: int
                     ) -> Tuple[List[str], List[str], List[str]]:
    """Reference fold split (prepare_dataset.py:1647-1658)."""
    cases = list(cases)
    ncases = len(cases)
    rng = random.Random(fold)
    train = rng.sample(cases, int(0.7 * ncases))
    val = rng.sample(train, int(0.2 * len(train)))
    train = list(set(train) - set(val))
    test = list(set(cases) - set(train) - set(val))
    assert not set(train) & set(val)
    assert not set(train) & set(test)
    return train, val, test


def _unique(values) -> List[Any]:
    """Distinct values in order of first appearance (pandas' unique)."""
    return list(dict.fromkeys(values))


def balance_classes(rows: Sequence[Row], label_col: str,
                    labels: Sequence) -> List[Row]:
    """balance_scores (prepare_dataset.py:1627-1635): downsample every class
    to the minority count, as DataFrame.sample(n, random_state=0)."""
    counts = {}
    for r in rows:
        counts[r[label_col]] = counts.get(r[label_col], 0) + 1
    n = min(counts.values())
    out: List[Row] = []
    for lab in labels:
        part = [r for r in rows if r[label_col] == lab]
        pick = np.random.RandomState(0).permutation(len(part))[:n]
        out.extend(part[i] for i in pick)
    return out


@dataclasses.dataclass
class SegmentDataset:
    """Phase-split segment tables for one fold."""

    frames: Dict[str, List[Row]]     # phase -> rows
    classes: List[Any]               # sorted label names (LabelEncoder)


def build_segment_dataset(segments: Sequence[Row], fold: int,
                          label_col: str = "Gesture",
                          video_col: str = "Video",
                          balance: bool = True) -> SegmentDataset:
    """Split labeled segments into train/val/test with the reference fold
    and balancing policies (obtain_train_val_split,
    prepare_dataset.py:1637-1668)."""
    classes = sorted(_unique(r[label_col] for r in segments))
    train_v, val_v, test_v = fold_video_split(
        _unique(r[video_col] for r in segments), fold)
    out = {}
    for phase, vids in (("train", train_v), ("val", val_v), ("test", test_v)):
        chosen = set(vids)
        sub = [r for r in segments if r[video_col] in chosen]
        if sub and (balance or phase in ("val", "test")):
            present = [c for c in classes
                       if any(r[label_col] == c for r in sub)]
            sub = balance_classes(sub, label_col, present)
        out[phase] = sub
    return SegmentDataset(out, classes)


def batched_indices(n: int, batch_size: int, shuffle: bool,
                    seed: int = 0) -> List[np.ndarray]:
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    return [idx[i:i + batch_size] for i in range(0, n, batch_size)]


class CachingStore:
    """Per-batch read cache over a FeatureStore-like object: the 3-way TTA
    collation reads each row's video once per batch instead of once per
    variant.  Scope one instance per batch so memory stays bounded."""

    def __init__(self, store):
        self._store = store
        self._cache = {}

    def read_video(self, name):
        if name not in self._cache:
            self._cache[name] = self._store.read_video(name)
        return self._cache[name]
