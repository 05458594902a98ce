"""Named dataset policies from the reference's per-dataset branches: the
part of `sais_tpu/data/reference_datasets.py` that `train` and `assess`
reach, without pandas (tables are row lists, `data.datasets`; each
function returns the rows pandas returns there, in the same order):

- class balancing by downsampling to the minority count with
  random_state=1 (balance_gestures, prepare_dataset.py:1502-1511);
- the per-gesture video split, 90/10, with the reference's
  val-subset-of-train quirk (prepare_dataset.py:1047-1076, 1548-1567);
  the instance split 80/20 (:1577-1590, val == test); leave-one-user-out
  (:1513-1537);
- the minimum-duration filter (> 10 frames, :969-977) and the
  gesture-timestamp tables: VUA_Gestures_Classification (:1283-1395) and
  DVC_UCL_Gestures_Classification (:1396-1500), over the shared timestamp
  cleanup;
- the VUA_EASE_Stitch windows and sub-phase tables (getStartAndEndFrame,
  :600-612; the training path, :428-568);
- the USC surgeon / patient meta table (loadMetaInfo, :240-257) and the
  `-bg` / `-sg` group balancing and restriction over it (balanceGroups /
  getSingleGroup, :190-236).

The RNG semantics are the reference's: python `random` seeded with the
fold, and DataFrame.sample(n, random_state=r), which takes the first n of
np.random.RandomState(r).permutation(len).  pandas' `unique` keeps the
order of first appearance, `isin` keeps the table's order and `concat`
the parts' order; pandas' date parsing, pd.cut and pd.qcut are
reproduced for the meta table, whose group labels are `Category` values,
so value_counts and merges see their category order.
"""

from __future__ import annotations

import datetime
import random
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from sais_tpu_torch.data.datasets import (NAN, Category, Row, _unique,
                                          isna, merge_rows)
from sais_tpu_torch.data.skill import _sample


def _isin(rows: Sequence[Row], col: str, values) -> List[Row]:
    chosen = set(values)
    return [r for r in rows if r[col] in chosen]


def balance_gestures(rows: Sequence[Row], label_col: str = "Gesture",
                     random_state: int = 1) -> List[Row]:
    """Downsample every class to the minority count (balance_gestures,
    prepare_dataset.py:1502-1511; random_state=1 here, 0 in the
    'maj'-label variant), the classes in order of first appearance."""
    labels = _unique(r[label_col] for r in rows)
    counts = [sum(1 for r in rows if r[label_col] == lab) for lab in labels
              if not isna(lab)]
    n = min(counts)
    out: List[Row] = []
    for lab in labels:
        out += _sample([r for r in rows if r[label_col] == lab], n,
                       random_state)
    return out


def per_gesture_video_split(rows: Sequence[Row], fold: int,
                            balance: bool = True,
                            label_col: str = "Gesture",
                            video_col: str = "Video"
                            ) -> Tuple[List[Row], List[Row], List[Row]]:
    """kind='Video' split (prepare_dataset.py:1047-1076): per gesture,
    90% of videos train; val is 10% OF ALL VIDEOS sampled from the train
    pool (`int(0.1*nvids)`, :1068 — NOT 10% of train); the original leaves
    val inside train (the subtraction is commented out) — preserved.
    balance=False still balances val and test."""
    parts: Tuple[List[Row], List[Row], List[Row]] = ([], [], [])
    for gesture in sorted(_unique(r[label_col] for r in rows)):
        cur = [r for r in rows if r[label_col] == gesture]
        vids = _unique(r[video_col] for r in cur)
        rng = random.Random(fold)
        train_vids = rng.sample(vids, int(0.9 * len(vids)))
        val_vids = rng.sample(train_vids, int(0.1 * len(vids)))
        test_vids = list(set(vids) - set(train_vids) - set(val_vids))
        for part, chosen in zip(parts, (train_vids, val_vids, test_vids)):
            part += _isin(cur, video_col, chosen)
    return tuple(balance_gestures(d, label_col)
                 if d and (balance or i > 0) else d
                 for i, d in enumerate(parts))


def instance_split(rows: Sequence[Row], balance: bool = True,
                   label_col: str = "Gesture"
                   ) -> Tuple[List[Row], List[Row], List[Row]]:
    """kind='Instance' 80/20 split (prepare_dataset.py:1577-1590);
    test == val in the reference."""
    if balance:
        rows = balance_gestures(rows, label_col)
    n = len(rows)
    indices = random.Random(0).sample(list(range(n)), n)
    ntrain = int(0.8 * n)
    val = [rows[i] for i in indices[ntrain:]]
    return [rows[i] for i in indices[:ntrain]], val, list(val)


def leave_one_user_out_split(rows: Sequence[Row], fold: int,
                             subject_col: str = "Subject"
                             ) -> Tuple[List[Row], List[Row], List[Row]]:
    """JIGSAWS kind='User' (prepare_dataset.py:1513-1537): test user is
    users[fold] (users in order of first appearance); the remaining users,
    sorted, are fold-seed shuffled, the last one is val, the rest train."""
    users = _unique(r[subject_col] for r in rows)
    test_user = users[fold]
    others = set(users) - {test_user}
    shuffled = random.Random(fold).sample(sorted(others), len(others))
    return (_isin(rows, subject_col, shuffled[:-1]),
            [r for r in rows if r[subject_col] == shuffled[-1]],
            [r for r in rows if r[subject_col] == test_user])


def filter_min_frames(rows: Sequence[Row], min_nframes: int = 10
                      ) -> List[Row]:
    """Drop gestures spanning <= min_nframes (prepare_dataset.py:969-977)."""
    return [r for r in rows if r["EndFrame"] - r["StartFrame"] > min_nframes]


# ---------------------------------------------------------------------------
# VUA_Gestures_Classification (prepare_dataset.py:1283-1395)
# ---------------------------------------------------------------------------

def clean_gesture_timestamps(rows: Sequence[Row],
                             int_labels: bool = True) -> List[Row]:
    """Shared timestamp-CSV cleanup (prepare_dataset.py:1358-1364 and
    :1476-1482): Video from the path tail, stripped labels, drop NaN and
    multi-label rows, integer-cast gestures.  The cast is str -> int, as
    pandas' astype(int) of the stripped strings: a numeric Gesture column
    with an empty cell is float, its labels read '1.0', and the cast
    raises ValueError there, as it does in the JAX package."""
    out = []
    for r in rows:
        r = dict(r)
        if "Video" not in r:
            p = r["Path"]
            r["Video"] = p.split("\\")[-1] if "\\" in p else p.split("/")[-1]
        r["Gesture"] = str(r["Gesture"]).strip()
        if r["Gesture"] != "nan" and len(r["Gesture"].split(",")) == 1:
            out.append(r)
    if int_labels:
        for r in out:
            r["Gesture"] = int(r["Gesture"])
    return out


VUA_TOP4_GESTURES = [1, 2, 7, 13]  # prepare_dataset.py:1378


def vua_gestures_tables(rows: Sequence[Row], domain: str, fold: int,
                        balance: bool = True
                        ) -> Tuple[Dict[str, List[Row]], List]:
    """VUA_Gestures_Classification (prepare_dataset.py:1283-1395):
    domain = 'Top4' or 'X_vs_Y'; per-gesture video split with the
    val-inside-train quirk; phases include the merged 'train+val' table
    the reference loader exposes (:1392-1394)."""
    rows = clean_gesture_timestamps(rows)
    if "vs" in domain:
        gestures = [int(g) for g in domain.split("_vs_")]
    else:  # 'Top4'
        gestures = VUA_TOP4_GESTURES
    tr, va, te = per_gesture_video_split(_isin(rows, "Gesture", gestures),
                                         fold, balance=balance)
    classes = sorted(_unique(r["Gesture"] for r in tr))
    return {"train": tr, "val": va, "train+val": tr + va, "test": te}, \
        classes


# ---------------------------------------------------------------------------
# DVC_UCL_Gestures_Classification (prepare_dataset.py:1396-1500)
# ---------------------------------------------------------------------------

DVC_UCL_GESTURES = [0, 1, 2, 3, 4, 6, 7]  # :1488 ('removed 5 b/c not enough')


def dvc_ucl_tables(rows: Sequence[Row], fold: int, balance: bool = True
                   ) -> Tuple[Dict[str, List[Row]], List]:
    """DVC_UCL branch: unlike the NS/VUA splits, the 'Feb 26 2022'
    train-minus-val subtraction IS active here (:1432), and the loader
    trains on train+val merged with the test split as both val and test
    (:1497)."""
    rows = _isin(clean_gesture_timestamps(rows), "Gesture", DVC_UCL_GESTURES)
    tr: List[Row] = []
    va: List[Row] = []
    te: List[Row] = []
    for gesture in sorted(_unique(r["Gesture"] for r in rows)):
        cur = [r for r in rows if r["Gesture"] == gesture]
        vids = _unique(r["Video"] for r in cur)
        rng = random.Random(fold)
        train_vids = rng.sample(vids, int(0.9 * len(vids)))
        val_vids = rng.sample(train_vids, int(0.1 * len(vids)))
        train_vids = list(set(train_vids) - set(val_vids))
        test_vids = list(set(vids) - set(train_vids) - set(val_vids))
        tr += _isin(cur, "Video", train_vids)
        va += _isin(cur, "Video", val_vids)
        te += _isin(cur, "Video", test_vids)
    if balance and tr:
        tr = balance_gestures(tr)
    va = balance_gestures(va) if va else va
    te = balance_gestures(te) if te else te
    classes = sorted(_unique(r["Gesture"] for r in tr))
    return {"train": tr + va, "val": te, "test": te}, classes


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


# ---------------------------------------------------------------------------
# Library-only tables: no command of either package reaches them
# ---------------------------------------------------------------------------

JIGSAWS_GESTURES = ["G2", "G3", "G6", "G4", "G8", "G11", "G5", "G1", "G9",
                    "G10"]
DART_DOMAINS = ("GS", "IVA", "RTP", "TH", "TR", "E")
NS_TOP6_GESTURES = ["p", "h", "c", "r", "m", "k"]  # prepare_dataset.py:856


def jigsaws_phase_tables(rows: Sequence[Row], fold: int,
                         balance: bool = True) -> Dict[str, List[Row]]:
    """The JIGSAWS branch trains on train + val merged and uses the
    held-out user for both val and test (prepare_dataset.py:1619-1622)."""
    rows = _isin(rows, "Gesture", JIGSAWS_GESTURES)
    train, val, test = leave_one_user_out_split(rows, fold)
    if balance:
        train = balance_gestures(train)
        val = balance_gestures(val) if val else val
        test = balance_gestures(test) if test else test
    return {"train": train + val, "val": test, "test": test}


def dart_band(score: float) -> float:
    """group_dart banding (prepare_dataset.py:949-956): <= 2.6 -> 0,
    <= 2.8 -> 1, <= 3.0 -> 2, above 3.0 (and NaN) unchanged."""
    if score <= 2.6:
        return 0
    if score <= 2.8:
        return 1
    if score <= 3.0:
        return 2
    return score


def _rater_majority(values: Sequence[Any]) -> Any:
    """The majority of the non-NaN scores; of tied counts the one counted
    last in first-seen order (a stable sort by count)."""
    counts = {}
    for v in values:
        if not isna(v):
            counts[v] = counts.get(v, 0) + 1
    return sorted(counts.items(), key=lambda el: el[1])[-1][0]


def aggregate_dart_scores(rows: Sequence[Row], domain: str = "TR",
                          style: str = "mean",
                          keep_extremes: bool = True) -> List[Row]:
    """NS_DART rater aggregation (prepare_dataset.py:929-961): per domain
    AVE_<d> over raters 1-5 (the mean of the non-NaN scores, or their
    majority), the chosen domain's banded (`dart_band`), and optionally
    only bands {0, 2} kept."""
    out = []
    for r in rows:
        r = dict(r)
        for d in DART_DOMAINS:
            vals = [r[f"{d}{i}"] for i in range(1, 6)]
            if style == "mean":
                kept = [float(v) for v in vals if not isna(v)]
                r[f"AVE_{d}"] = sum(kept) / len(kept) if kept else NAN
            else:
                # a row of pandas' apply is one float Series
                r[f"AVE_{d}"] = float(_rater_majority(vals))
        out.append(r)
    col = f"AVE_{domain}"
    bands = [dart_band(r[col]) for r in out]
    if any(isinstance(b, float) for b in bands):
        bands = [float(b) for b in bands]   # pandas' one column dtype
    for r, b in zip(out, bands):
        r[col] = b
    if keep_extremes:
        out = [r for r in out if r[col] in (0, 2)]
    return out


def dart_video_split(rows: Sequence[Row], fold: int,
                     video_col: str = "Video"
                     ) -> Tuple[List[Row], List[Row], List[Row]]:
    """NS_DART 90/10 split (prepare_dataset.py:997-1006): val is 10% OF
    ALL CASES, sampled from the train pool."""
    cases = _unique(r[video_col] for r in rows)
    rng = random.Random(fold)
    train_cases = rng.sample(cases, int(0.9 * len(cases)))
    val_cases = rng.sample(train_cases, int(0.1 * len(cases)))
    train_cases = list(set(train_cases) - set(val_cases))
    test_cases = list(set(cases) - set(train_cases) - set(val_cases))
    return tuple(_isin(rows, video_col, chosen)
                 for chosen in (train_cases, val_cases, test_cases))


def ns_vs_vua_tables(vua_stitch: Sequence[Row],
                     ns_timestamps: Sequence[Row], fold: int,
                     balance: bool = True, training_fraction: float = 1.0
                     ) -> Tuple[Dict[str, List[Row]], List[str]]:
    """The combined NS-vs-VUA activity-discrimination dataset
    (prepare_dataset.py:569-888, training path).

    VUA part: EASE stitch rows filtered by duration and the three RACE /
    EASE pairings, maj in {0, 1, 2}, windows from `vua_ease_window`, a
    0.9 / 0.1 video split (val = 10% of TRAIN here, :698-701), -tf
    subsampling of its train rows; NS part: gesture timestamps without
    P-129, > 10 frames, gestures with > 100 rows, Note-free rows, the Top6
    gestures, the per-gesture split; each phase's domains balanced to the
    minority count (random_state=1, :879-881).  Rows keep StartFrame,
    EndFrame, Domain and Video."""
    from sais_tpu_torch.data.skill import duration_filter
    vua = [r for r in vua_stitch if r["File"] not in (102, 372)]
    if vua and "Video" not in vua[0]:
        vua = [dict(r, Video=r["Path"].split("\\")[-1]) for r in vua]
    vua = duration_filter(vua)
    vua = [r for r in vua if any(r["RACE"] == race and r["EASE"] == ease
                                 for race, ease in STITCH_PAIRS)
           and r["maj"] in (0, 1, 2)]
    spans = [vua_ease_window(r["RACE"], r) for r in vua]
    if any(isinstance(v, float) for span in spans for v in span):
        # pandas takes both columns at one dtype (to_numpy)
        spans = [tuple(float(v) for v in span) for span in spans]
    cols = ("StartFrame", "EndFrame", "Domain", "Video")
    vua = [{"StartFrame": s, "EndFrame": e, "Domain": "VUA",
            "Video": r["Video"]} for r, (s, e) in zip(vua, spans)]
    cases = _unique(r["Video"] for r in vua)
    rng = random.Random(fold)
    train_cases = rng.sample(cases, int(0.9 * len(cases)))
    val_cases = rng.sample(train_cases, int(0.1 * len(train_cases)))
    train_cases = list(set(train_cases) - set(val_cases))
    vua_tr = _isin(vua, "Video", train_cases)
    vua_va = _isin(vua, "Video", val_cases)
    held = set(train_cases) | set(val_cases)
    vua_te = [r for r in vua if r["Video"] not in held]
    if training_fraction < 1 and vua_tr:
        # -tf subsample of the VUA train rows (prepare_dataset.py:703-705)
        vua_tr = _sample(vua_tr, int(len(vua_tr) * training_fraction), 0)

    ns = clean_gesture_timestamps(ns_timestamps, int_labels=False)
    ns = [dict(r, Domain="NS") for r in ns if "P-129" not in r["Video"]]
    ns = filter_min_frames(ns)
    counts: Dict[Any, int] = {}
    for r in ns:
        counts[r["Gesture"]] = counts.get(r["Gesture"], 0) + 1
    ns = [r for r in ns if counts[r["Gesture"]] > 100]
    if ns and "Note" in ns[0]:
        ns = [r for r in ns if isna(r["Note"])]
    ns = _isin(ns, "Gesture", NS_TOP6_GESTURES)
    ns_parts = per_gesture_video_split(ns, fold, balance=balance)

    out = {}
    for phase, v_part, n_part in zip(("train", "val", "test"),
                                     (vua_tr, vua_va, vua_te), ns_parts):
        comb = v_part + [{c: r[c] for c in cols} for r in n_part]
        out[phase] = (balance_gestures(comb, label_col="Domain") if comb
                      else comb)
    return out, ["NS", "VUA"]


class DomainKeyedStore:
    """read_video dispatch over per-domain stores (the reference opens one
    h5 per domain for NS_vs_VUA, hf_rgb[domain], prepare_dataset.py:2439);
    rows must carry video names unique across the domains."""

    def __init__(self, stores: Dict[str, Any],
                 video_to_domain: Dict[str, str]):
        self.stores = stores
        self.video_to_domain = video_to_domain

    def read_video(self, name: str):
        return self.stores[self.video_to_domain[str(name)]].read_video(name)


def ns_vs_vua_batches(phase_rows: Sequence[Row], rgb_store, flow_store,
                      wcfg, batch_size: int, shuffle: bool, seed: int = 0,
                      tta: bool = False, use_flow: bool = False):
    """Collated NS_vs_VUA batches: fixed stride 10, the 2000-frame cap,
    label 0 = NS / 1 = VUA (prepare_dataset.py:2405-2438); rgb_store may
    be a DomainKeyedStore over the two domains' feature stores."""
    from sais_tpu_torch.data.collate import segment_batches
    return segment_batches(
        phase_rows, rgb_store, ["NS", "VUA"], wcfg, batch_size, shuffle,
        seed=seed, tta=tta, flow_store=flow_store if use_flow else None,
        fixed_stride=10, cap=2000,
        label_fn=lambda row: 0 if row["Domain"] == "NS" else 1,
        # segments run up to the 2000 cap, far past the skill buckets
        buckets=(16, 32, 64, 128, 256, 512, 1024, 2000))


def frame_cap(indices: np.ndarray, cap: int = 2000) -> np.ndarray:
    """The reference's hard cap of a sequence at 2000 frames
    (prepare_dataset.py:2437), the learned positional table's length."""
    return indices[:cap]


def gronau_gesture_inference_table(rows: Sequence[Row],
                                   gestures: Sequence[str] = tuple(
                                       NS_TOP6_GESTURES),
                                   random_state: int = 1) -> List[Row]:
    """Per-(PID, gesture) breadth-sampling inference table: of every pair
    with >= 3 examples, exactly 3 sampled.  The reference uses
    random_state=1 for Gronau_inference (prepare_dataset.py:794-827,
    :1150-1166) and 0 for RAPN_inference (:1180-1198)."""
    rows = clean_gesture_timestamps(rows, int_labels=False)
    rows = _isin(filter_min_frames(rows), "Gesture", gestures)
    out: List[Row] = []
    for pid in sorted(_unique(r["PID"] for r in rows)):
        for gesture in sorted(_unique(r["Gesture"] for r in rows)):
            cur = [r for r in rows
                   if r["PID"] == pid and r["Gesture"] == gesture]
            if len(cur) >= 3:
                out += _sample(cur, 3, random_state)
    return out


def rapn_gesture_inference_table(rows: Sequence[Row],
                                 gestures: Sequence[str] = tuple(
                                     NS_TOP6_GESTURES)) -> List[Row]:
    """The RAPN_inference variant (prepare_dataset.py:1180-1198)."""
    return gronau_gesture_inference_table(rows, gestures, random_state=0)


def cinvivo_inference_table(paths_rows: Sequence[Row], fps: int = 30,
                            duration_s: float = 0.5,
                            hop_s: float = 0.5) -> List[Row]:
    """CinVivo_inference windows (prepare_dataset.py:1199-1226): frames
    counted per (category, label) group of CinVivo_Paths.csv, groups in
    sorted order (pandas' groupby), and duration = hop = 0.5 s windows at
    30 fps laid over each: nsamples = (count - 15) // 15 + 1, StartFrame =
    n * 15, EndFrame = StartFrame + 15, Video = label, Domain = 'Gesture'.
    A group shorter than one window gives no rows."""
    dur, hop = int(duration_s * fps), int(hop_s * fps)
    counts: Dict[Tuple[Any, Any], int] = {}
    for r in paths_rows:
        key = (r["category"], r["label"])
        counts[key] = counts.get(key, 0) + 1
    out: List[Row] = []
    for (category, label), count in sorted(counts.items()):
        for n in range(max((count - dur) // hop + 1, 0)):
            out.append({"StartFrame": n * hop, "EndFrame": n * hop + dur,
                        "category": category, "label": label,
                        "Video": label, "Domain": "Gesture"})
    return out
