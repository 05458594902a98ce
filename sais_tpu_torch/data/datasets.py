"""Labeled-segment datasets: splits, class balancing, fold semantics.

Own copy of `sais_tpu/data/datasets.py` without pandas (the card's machine
has none).  A table is a list of dicts, one per row, keyed by column, read
from CSV with `read_segments`, which types each column as pandas' read_csv
would (int, then float, else str; an empty cell is NaN, and a column of
ints with empty cells is float).  The few pandas operations the skill
path's tables go through are here too: `concat_rows` (DataFrame concat),
`merge_rows` (DataFrame.merge, left and outer) and `Category` (a value of
a categorical column).
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
import math
import random
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

Row = Dict[str, Any]
NAN = float("nan")

# the cells read_csv reads as missing by default (pandas' na_values)
_NA_CELLS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})


def isna(value: Any) -> bool:
    """pandas.isna of one cell: None or a float NaN."""
    return value is None or (isinstance(value, float) and math.isnan(value))


def _typed_column(values: List[str]) -> List[Any]:
    present = [v for v in values if v not in _NA_CELLS]
    for cast in (int, float):
        try:
            [cast(v) for v in present]
        except ValueError:
            continue
        if len(present) < len(values):
            cast = float     # ints with missing cells are a float column
        return [NAN if v in _NA_CELLS else cast(v) for v in values]
    return [NAN if v in _NA_CELLS else v for v in values]


def read_segments(path: str) -> List[Row]:
    """A CSV -> rows, each column named and typed as pandas.read_csv names
    and types it (an empty header is 'Unnamed: <i>'; a missing cell is
    NaN; all ints -> int, ints and missing cells -> float, all numbers ->
    float, else str)."""
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
    """Phase-split segment tables for one fold.  skill_classes: the EASE
    branches' maj labels (or EASE domain names) in LabelEncoder order."""

    frames: Dict[str, List[Row]]     # phase -> rows
    classes: List[Any]               # sorted label names (LabelEncoder)
    skill_classes: Optional[List[Any]] = None


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


# ---------------------------------------------------------------------------
# The pandas operations of the skill path's tables
# ---------------------------------------------------------------------------

class Category(str):
    """One value of a pandas categorical column (pd.cut / pd.qcut labels):
    equal to and written as its label, ordered by its place among the
    column's `categories`, which value_counts counts even when absent."""

    def __new__(cls, label: str, categories: Sequence[str]):
        obj = super().__new__(cls, label)
        obj.categories = tuple(categories)
        return obj

    def __getnewargs__(self):
        return str(self), self.categories


def columns_of(rows: Sequence[Row]) -> List[str]:
    """The columns of a table: every key, in order of first appearance."""
    return list(dict.fromkeys(k for r in rows for k in r))


def concat_rows(parts: Sequence[Sequence[Row]]) -> List[Row]:
    """pd.concat(parts): the rows in order, a column a part lacks NaN."""
    cols = columns_of([r for p in parts for r in p])
    return [{c: r.get(c, NAN) for c in cols} for p in parts for r in p]


def _key(row: Row, on: Sequence[str]) -> Tuple:
    # merges match a missing key with a missing key, as pandas does
    return tuple("\0nan" if isna(row[c]) else row[c] for c in on)


def _rank(value: Any):
    return value.categories.index(value) if isinstance(value, Category) \
        else value


def merge_rows(left: Sequence[Row], right: Sequence[Row], on: Sequence[str],
               how: str = "left", indicator: bool = False,
               left_columns: Optional[Sequence[str]] = None,
               right_columns: Optional[Sequence[str]] = None) -> List[Row]:
    """pd.merge(left, right, how, on, indicator) for how 'left' or 'outer'.

    Columns: left's, then right's other columns; a non-key column both
    have becomes <c>_x / <c>_y.  'left' keeps left's order, each row once
    per matching right row (right's order) or once with NaN.  'outer'
    sorts by the keys, lexicographically in `on` order (each column by
    value, a Category by its code, missing last); within a key, left's
    rows (each paired with every matching right row) precede right's.
    The column lists are needed only where a table may be empty."""
    lcols = list(left_columns) if left_columns is not None else \
        columns_of(left)
    rcols = list(right_columns) if right_columns is not None else \
        columns_of(right)
    both = set(lcols) & set(rcols) - set(on)
    lname = {c: c + "_x" if c in both else c for c in lcols}
    rname = {c: c + "_y" if c in both else c for c in rcols if c not in on}

    def combine(lr: Optional[Row], rr: Optional[Row]) -> Row:
        out = {}
        for c in lcols:
            src = lr if lr is not None else (rr if c in on else None)
            out[lname[c]] = src.get(c, NAN) if src is not None else NAN
        for c, name in rname.items():
            out[name] = rr.get(c, NAN) if rr is not None else NAN
        if indicator:
            out["_merge"] = ("both" if lr is not None and rr is not None
                             else "left_only" if lr is not None
                             else "right_only")
        return out

    groups: Dict[Tuple, List[List[Row]]] = {}
    for side, rows in enumerate((left, right)):
        for r in rows:
            groups.setdefault(_key(r, on), [[], []])[side].append(r)
    if how == "left":
        out = []
        for lr in left:
            matches = groups[_key(lr, on)][1]
            out.extend(combine(lr, rr) for rr in matches or [None])
        return out
    if how != "outer":
        raise ValueError(f"merge how={how!r} is not supported")
    ranks = []
    for i in range(len(on)):
        values = {k[i] for k in groups if k[i] != "\0nan"}
        order = sorted(values, key=_rank)
        ranks.append({v: j for j, v in enumerate(order)})
        ranks[-1]["\0nan"] = len(order)
    out = []
    for k in sorted(groups, key=lambda k: [r[v] for r, v in zip(ranks, k)]):
        lrows, rrows = groups[k]
        if lrows and rrows:
            out.extend(combine(lr, rr) for lr in lrows for rr in rrows)
        else:
            out.extend(combine(lr, None) for lr in lrows)
            out.extend(combine(None, rr) for rr in rrows)
    return out
