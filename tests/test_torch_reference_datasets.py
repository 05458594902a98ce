"""The port's pandas-free reference dataset policies
(`sais_tpu_torch.data.reference_datasets`) against the JAX package's
pandas ones, row for row: the gesture-timestamp cleanup and tables
(vua-gestures, dvc-ucl), class balancing, the three named split policies
and the duration filter, over several folds with balancing on and off.
Each table is written to one CSV that pandas (`pd.read_csv`) and the
port (`read_segments`) both read: object Gesture columns with
multi-label and empty cells, Paths with either separator, and the float
Gesture column (a numeric column with an empty cell) on which both
packages raise."""

import csv
import math

import numpy as np
import pandas as pd
import pytest

from sais_tpu.data import reference_datasets as jref
from sais_tpu_torch.data import reference_datasets as ref
from sais_tpu_torch.data.datasets import read_segments

GESTURES = ["1", "2", "7", "13", " 2", "0", "3", "4", "6", "5", "1,2", ""]


def _timestamp_table(seed, nvideos=14, per_video=30, gestures=GESTURES,
                     users=5):
    """Gesture-timestamp rows (Path, StartFrame, EndFrame, Gesture,
    Subject): labels drawn from `gestures` (multi-label and empty cells
    among them), half the Paths with backslashes."""
    rng = np.random.default_rng(seed)
    rows = []
    for v in range(nvideos):
        sep = "\\" if v % 2 else "/"
        path = sep.join(["data", f"site{v % 3}", f"video_{v:02d}"])
        for _ in range(per_video):
            start = int(rng.integers(1, 2000))
            rows.append({"Path": path, "StartFrame": start,
                         "EndFrame": start + int(rng.integers(5, 90)),
                         "Gesture": gestures[int(rng.integers(
                             len(gestures)))],
                         "Subject": f"U{int(rng.integers(users))}"})
    return rows


def _write(path, rows):
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)


def _both(tmp_path, rows, name="t.csv"):
    """(port rows, pandas frame) of one CSV."""
    _write(tmp_path / name, rows)
    return read_segments(str(tmp_path / name)), pd.read_csv(tmp_path / name)


def _same(got, want):
    """Port rows == pandas frame, row for row (NaN equal to NaN)."""
    records = want.to_dict("records")
    assert len(got) == len(records)
    for g, w in zip(got, records):
        assert list(g) == list(w)
        for k in w:
            if isinstance(w[k], float) and math.isnan(w[k]):
                assert isinstance(g[k], float) and math.isnan(g[k]), k
            else:
                assert g[k] == w[k] and type(g[k]) is type(w[k]), (k, g[k],
                                                                   w[k])


@pytest.fixture
def table(tmp_path):
    return _both(tmp_path, _timestamp_table(0))


def test_read_and_clean_gesture_timestamps(table):
    """The CSV reads alike (object Gesture column with NaN cells); the
    cleanup derives Video from either separator, strips, drops NaN and
    multi-label rows and casts to int, as pandas does."""
    rows, df = table
    _same(rows, df)
    got = ref.clean_gesture_timestamps(rows)
    want = jref.clean_gesture_timestamps(df)
    _same(got, want)
    assert {r["Video"] for r in got} == {f"video_{v:02d}" for v in range(14)}
    _same(ref.clean_gesture_timestamps(rows, int_labels=False),
          jref.clean_gesture_timestamps(df, int_labels=False))


def test_float_gesture_column_raises_as_in_jax(tmp_path):
    """A numeric Gesture column with an empty cell is float in both
    readers; its labels read '1.0' and the int cast raises the same
    ValueError in both packages (a reference behaviour, ROADMAP Queue 3)."""
    rows, df = _both(tmp_path, _timestamp_table(
        1, nvideos=3, per_video=6, gestures=["1", "2", ""]))
    assert df["Gesture"].dtype == np.float64
    msgs = []
    for fn, table in ((jref.clean_gesture_timestamps, df),
                      (ref.clean_gesture_timestamps, rows)):
        with pytest.raises(ValueError) as info:
            fn(table)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1] == \
        "invalid literal for int() with base 10: '1.0'"


@pytest.mark.parametrize("random_state", [0, 1])
def test_balance_gestures_matches_pandas(table, random_state):
    """Every class downsampled to the minority count with
    sample(n, random_state), the classes in order of appearance."""
    rows, df = table
    got = ref.clean_gesture_timestamps(rows)
    want = jref.clean_gesture_timestamps(df)
    _same(ref.balance_gestures(got, random_state=random_state),
          jref.balance_gestures(want, random_state=random_state))


@pytest.mark.parametrize("balance", [True, False])
def test_per_gesture_video_split_matches_pandas(table, balance):
    """Folds 0-4: train, val (inside train, the reference's quirk) and
    test, the same rows in the same order."""
    rows, df = table
    got_rows = ref.clean_gesture_timestamps(rows)
    want_df = jref.clean_gesture_timestamps(df)
    for fold in range(5):
        got = ref.per_gesture_video_split(got_rows, fold, balance=balance)
        want = jref.per_gesture_video_split(want_df, fold, balance=balance)
        for g, w in zip(got, want):
            _same(g, w)
        assert {r["Video"] for r in got[1]} <= {r["Video"] for r in got[0]}


@pytest.mark.parametrize("balance", [True, False])
def test_instance_split_matches_pandas(table, balance):
    rows, df = table
    got = ref.instance_split(ref.clean_gesture_timestamps(rows),
                             balance=balance)
    want = jref.instance_split(jref.clean_gesture_timestamps(df),
                               balance=balance)
    for g, w in zip(got, want):
        _same(g, w)
    assert got[1] == got[2]


def test_leave_one_user_out_split_matches_pandas(table):
    """Each user as the test user in turn (users in order of first
    appearance, the rest sorted then fold-shuffled)."""
    rows, df = table
    for fold in range(5):
        got = ref.leave_one_user_out_split(rows, fold)
        want = jref.leave_one_user_out_split(df, fold)
        for g, w in zip(got, want):
            _same(g, w)
        assert len({r["Subject"] for r in got[1]}) == 1


def test_filter_min_frames_matches_pandas(table):
    rows, df = table
    for n in (10, 40):
        _same(ref.filter_min_frames(rows, n), jref.filter_min_frames(df, n))


@pytest.mark.parametrize("domain", ["Top4", "1_vs_2", "7_vs_13"])
@pytest.mark.parametrize("balance", [True, False])
def test_vua_gestures_tables_match_pandas(table, domain, balance):
    """VUA_Gestures_Classification, folds 0-3: every phase (train+val
    included) row for row, and the classes in int order."""
    rows, df = table
    for fold in range(4):
        got, gcls = ref.vua_gestures_tables(rows, domain, fold,
                                            balance=balance)
        want, wcls = jref.vua_gestures_tables(df, domain, fold,
                                              balance=balance)
        assert gcls == wcls and gcls == sorted(gcls)
        assert list(got) == list(want)
        for ph in want:
            _same(got[ph], want[ph])


@pytest.mark.parametrize("balance", [True, False])
def test_dvc_ucl_tables_match_pandas(table, balance):
    """DVC_UCL: the train-minus-val subtraction, train+val merged, test as
    both val and test; folds 0-3."""
    rows, df = table
    for fold in range(4):
        got, gcls = ref.dvc_ucl_tables(rows, fold, balance=balance)
        want, wcls = jref.dvc_ucl_tables(df, fold, balance=balance)
        assert gcls == wcls == [0, 1, 2, 3, 4, 6, 7]
        for ph in ("train", "val", "test"):
            _same(got[ph], want[ph])
        assert got["val"] is got["test"]
