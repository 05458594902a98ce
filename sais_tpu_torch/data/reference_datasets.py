"""Named dataset policies from the reference's per-dataset branches: the
part of `sais_tpu/data/reference_datasets.py` that the EASE skill and
stitch branches of `train` and `assess` use, without pandas (tables are
row lists, `data.datasets`; each function returns the rows pandas returns
there, in the same order):

- the VUA_EASE_Stitch windows and sub-phase tables (getStartAndEndFrame,
  prepare_dataset.py:600-612; the training path, :428-568);
- the USC surgeon / patient meta table (loadMetaInfo, :240-257) and the
  `-bg` / `-sg` group balancing and restriction over it (balanceGroups /
  getSingleGroup, :190-236).

pandas' date parsing, pd.cut and pd.qcut are reproduced for the meta
table; the group labels are `Category` values, so value_counts and merges
see their category order.  The gesture-timestamp tables and split
policies wait for their slice.
"""

from __future__ import annotations

import datetime
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from sais_tpu_torch.data.datasets import (NAN, Category, Row, isna,
                                          merge_rows)


def vua_ease_window(race: str, row: Row) -> Tuple[Any, Any]:
    """getStartAndEndFrame (prepare_dataset.py:600-612): NW windows are
    +/-40 frames around the withdrawal start; NH/ND span their phases."""
    if race == "Needle Withdrawal":
        s = row["Needle Withdrawal Start Frame"]
        return s - 40, s + 40
    if race == "Needle Handling":
        return (row["Needle Handling Start Frame"],
                row["Needle Entry Start Frame"])
    return (row["Needle Entry Start Frame"],
            row["Needle Withdrawal Start Frame"])


STITCH_PAIRS = (("Needle Withdrawal", "Wrist Rotation"),
                ("Needle Handling", "# Repositions"),
                ("Needle Driving", "Driving Sequence"))


def stitch_phase_tables(stitch_rows: Sequence[Row], fold: int,
                        training_fraction: float = 1.0
                        ) -> Tuple[Dict[str, List[Row]], List[str]]:
    """VUA_EASE_Stitch sub-phase recognition, TRAINING path
    (prepare_dataset.py:428-568, `else` branch at :513-565).

    Rows are EASE stitch annotations; the label is the EASE domain name
    (equivalently the RACE sub-phase: NH vs ND vs NW).  Reproduces the
    reference exactly: File 102/372 exclusion, per-RACE duration filter,
    the three RACE/EASE pairings with maj in {0,1,2}, the fold-seeded
    0.9/0.1 video split, Domain='NH_vs_ND_vs_NW', and the -tf
    training-fraction subsample (df_train.sample(n, random_state=0),
    :549-551).  Classes are returned in LabelEncoder (alphabetical) order.
    """
    from sais_tpu_torch.data.skill import (duration_filter,
                                           ease_video_split, with_video)

    rows = with_video([r for r in stitch_rows if r["File"] not in (102, 372)])
    rows = [r for r in duration_filter(rows)
            if (r["RACE"], r["EASE"]) in STITCH_PAIRS and r["maj"] in (0, 1, 2)]
    tr, va, te = (
        [dict(r, Domain="NH_vs_ND_vs_NW") for r in part]
        for part in ease_video_split(rows, fold))
    if training_fraction < 1 and tr:
        pick = np.random.RandomState(0).permutation(len(tr))
        tr = [tr[i] for i in pick[:int(len(tr) * training_fraction)]]
    classes = sorted(["Wrist Rotation", "# Repositions", "Driving Sequence"])
    return {"train": tr, "val": va, "test": te}, classes


# ---------------------------------------------------------------------------
# Group balancing (-bg) over surgeon/patient meta (prepare_dataset.py:190-257)
# ---------------------------------------------------------------------------

# the formats pd.to_datetime may infer from a table's first date, in the
# order they are tried; the one that parses it is then required of every
# date (pandas 2+ infers one format and raises on a date it does not fit)
_DATE_FORMATS = ("%Y-%m-%d", "%Y-%m-%d %H:%M:%S", "%m/%d/%Y",
                 "%m/%d/%Y %H:%M", "%m/%d/%y", "%d/%m/%Y", "%Y/%m/%d")


def to_datetime(values: Sequence[Any]) -> List[Any]:
    """pd.to_datetime of a column of date strings: one format, inferred from
    the first date, for every date; a missing cell stays missing (NaN); a
    date the format does not fit raises ValueError (no guessing)."""
    present = [v for v in values if not isna(v)]
    if not present:
        return [NAN] * len(values)
    for fmt in _DATE_FORMATS:
        try:
            datetime.datetime.strptime(str(present[0]), fmt)
        except ValueError:
            continue
        return [NAN if isna(v) else datetime.datetime.strptime(str(v), fmt)
                for v in values]
    raise ValueError(f"cannot infer the date format of {present[0]!r}")


def cut(values: Sequence[Any], bins: Sequence[float], labels: Sequence[str],
        include_lowest: bool = False) -> List[Any]:
    """pd.cut(values, bins, labels): right-closed intervals (bins[i],
    bins[i+1]] -> labels[i] (a Category); outside every interval, or
    missing -> NaN.  include_lowest also takes bins[0] into the first."""
    edges = np.asarray(bins, np.float64)
    out = []
    for v in values:
        if isna(v):
            out.append(NAN)
            continue
        i = int(np.searchsorted(edges, v, side="left"))
        if include_lowest and v == edges[0]:
            i = 1
        out.append(NAN if i == 0 or i == len(edges)
                   else Category(labels[i - 1], labels))
    return out


def qcut(values: Sequence[Any], q: Sequence[float], labels: Sequence[str]
         ) -> List[Any]:
    """pd.qcut(values, q, labels): the bins are the quantiles q of the
    values present (linear interpolation, np.quantile's default, as
    Series.quantile), the lowest value included in the first bin."""
    present = np.asarray([v for v in values if not isna(v)], np.float64)
    bins = np.quantile(present, q)
    if len(np.unique(bins)) < len(bins) and len(bins) != 2:
        raise ValueError(f"Bin edges must be unique: {bins!r}")
    return cut(values, bins, labels, include_lowest=True)


def prepare_usc_meta(meta_rows: Sequence[Row]) -> List[Row]:
    """loadMetaInfo USC path (prepare_dataset.py:240-257): caseload from
    the surgery-year column, novice/expert banding at 100 cases, median
    splits for prostate volume / age / BMI."""
    rows = [dict(r, TaskID=int(r["TaskID"])) for r in meta_rows]
    for r, d in zip(rows, to_datetime([r["Surgery Date"] for r in rows])):
        r["Surgery Date"] = d
        r["Surgery Year"] = NAN if isna(d) else int(d.year)
    for r in rows:
        year = r["Surgery Year"]
        cases = (r[f"{year} Robotic Cases"]
                 if year in (2016, 2017, 2018, 2019) else NAN)
        r["Caseload"] = -1 if isna(cases) else int(cases)
    columns = (
        ("Caseload Group", cut([r["Caseload"] for r in rows],
                               [0, 100, float("inf")], ["novice", "expert"])),
        ("Prostate Volume Group", qcut([r["Prostate volume"] for r in rows],
                                       [0, 0.5, 1], ["≤49", ">49"])),
        ("Patient Age Group", qcut([r["Age"] for r in rows], [0, 0.5, 1],
                                   ["≤66", ">66"])),
        ("Patient BMI Group", qcut([r["BMI"] for r in rows], [0, 0.5, 1],
                                   ["≤28", ">28"])))
    for name, values in columns:
        for r, v in zip(rows, values):
            r[name] = v
    return rows


def _with_meta(rows: Sequence[Row], meta_rows: Sequence[Row]) -> List[Row]:
    """The shared preamble of balanceGroups / getSingleGroup: TaskID from
    Anatomy (11 posterior, else 12), 'File' -> 'CaseID' in the column names,
    then a left merge with the first meta row of each (CaseID, TaskID)."""
    seen, meta = set(), []
    for m in meta_rows:
        key = (m["CaseID"], m["TaskID"])
        if key not in seen:
            seen.add(key)
            meta.append(m)
    tagged = [{k.replace("File", "CaseID"): v for k, v in
               dict(r, TaskID=11 if r["Anatomy"] == "Posterior" else 12)
               .items()} for r in rows]
    return merge_rows(tagged, meta, ["CaseID", "TaskID"], "left")


def _value_counts(values: Sequence[Any], categories: Sequence[str] = ()
                  ) -> Dict[Any, int]:
    """Series.value_counts: the present values' counts, missing dropped;
    a categorical column counts every category, absent ones as 0."""
    counts: Dict[Any, int] = {c: 0 for c in categories}
    for v in values:
        if not isna(v):
            counts[v] = counts.get(v, 0) + 1
    return counts


def balance_groups(rows: Sequence[Row], meta_rows: Sequence[Row],
                   group: str = "Caseload Group") -> List[Row]:
    """balanceGroups (prepare_dataset.py:190-213): merge surgeon/patient
    meta by (CaseID, TaskID), then within every skill class downsample each
    group value to the per-class minority count (random_state=0)."""
    from sais_tpu_torch.data.skill import _sample
    df = _with_meta(rows, meta_rows)
    categories = next((m[group].categories for m in meta_rows
                       if isinstance(m.get(group), Category)), ())
    final: List[Row] = []
    for label in dict.fromkeys(r["maj"] for r in df):
        cur = [r for r in df if r["maj"] == label]
        counts = _value_counts([r[group] for r in cur], categories)
        if not counts:
            raise ValueError(f"cannot convert float NaN to integer: no "
                             f"{group} value among maj {label} rows")
        min_amount = min(counts.values())
        for group_val in dict.fromkeys(r[group] for r in cur
                                       if not isna(r[group])):
            final += _sample([r for r in cur if r[group] == group_val],
                             min_amount)
    return final


def single_group(rows: Sequence[Row], meta_rows: Sequence[Row], group: str,
                 group_val: str) -> List[Row]:
    """getSingleGroup (prepare_dataset.py:215-236): keep only rows whose
    merged meta matches one group value (e.g. prostate volume > 60 ml)."""
    return [r for r in _with_meta(rows, meta_rows) if r[group] == group_val]
