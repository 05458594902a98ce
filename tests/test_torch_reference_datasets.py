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


# ---------------------------------------------------------------------------
# The library-only tables (JIGSAWS, DART, NS_vs_VUA, inference tables)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("balance", [True, False])
def test_jigsaws_phase_tables_match_pandas(tmp_path, balance):
    """JIGSAWS: the JIGSAWS gestures only, leave-one-user-out, train + val
    merged, the held-out user as val and test; folds 0-3."""
    rows, df = _both(tmp_path, _timestamp_table(
        3, gestures=["G1", "G2", "G3", "G5", "G11", "G7", "G12"], users=5))
    for fold in range(4):
        got = ref.jigsaws_phase_tables(rows, fold, balance=balance)
        want = jref.jigsaws_phase_tables(df, fold, balance=balance)
        for ph in ("train", "val", "test"):
            _same(got[ph], want[ph])


def _dart_table(seed=4, nvideos=12, per_video=5):
    """NS_DART rows: a Video and five raters' scores per domain, some cells
    empty (the column then float)."""
    rng = np.random.default_rng(seed)
    rows = []
    for v in range(nvideos):
        for i in range(per_video):
            row = {"Video": f"dart_{v:02d}", "Clip": i}
            for d in jref.DART_DOMAINS:
                for k in range(1, 6):
                    row[f"{d}{k}"] = ("" if rng.random() < 0.1 else
                                      int(rng.integers(2, 5)))
            rows.append(row)
    return rows


@pytest.mark.parametrize("style", ["mean", "majority"])
@pytest.mark.parametrize("domain", ["TR", "GS"])
def test_dart_tables_match_pandas(tmp_path, style, domain):
    """The DART trio: dart_band over the band edges and past them, the
    rater aggregation (mean or majority of the non-NaN scores, banded,
    with and without the {0, 2} restriction) and the 90 / 10 video split,
    folds 0-2, row for row."""
    for score in (1.0, 2.6, 2.61, 2.8, 2.9, 3.0, 3.4, float("nan")):
        got, want = ref.dart_band(score), jref.dart_band(score)
        assert got == want or (math.isnan(got) and math.isnan(want))
    rows, df = _both(tmp_path, _dart_table())
    for keep in (True, False):
        got = ref.aggregate_dart_scores(rows, domain, style, keep)
        want = jref.aggregate_dart_scores(df, domain, style, keep)
        _same(got, want.reset_index(drop=True))
        for fold in range(3):
            for g, w in zip(ref.dart_video_split(got, fold),
                            jref.dart_video_split(want, fold)):
                _same(g, w)


def _ns_timestamps(seed=5, nvideos=12, per_video=120):
    """NS gesture timestamps: the Top6 letters and others, a P-129 video,
    short spans, a Note column with some notes."""
    rng = np.random.default_rng(seed)
    letters = ["p", "h", "c", "r", "m", "k", "x", "y"]
    rows = []
    for v in range(nvideos):
        path = f"data\\P-{129 if v == 0 else 200 + v}"
        for _ in range(per_video):
            start = int(rng.integers(1, 3000))
            rows.append({"Path": path, "StartFrame": start,
                         "EndFrame": start + int(rng.integers(4, 60)),
                         "Gesture": letters[int(rng.integers(len(letters)))],
                         "Note": "" if rng.random() < 0.9 else "blur"})
    return rows


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_ns_vs_vua_tables_match_pandas(tmp_path, fraction):
    """NS_vs_VUA: the VUA stitch part (File and pairing filters, windows,
    the 0.9 / 0.1-of-train split, -tf) and the NS part (P-129, > 10
    frames, > 100 rows, Note-free, Top6, per-gesture split), each phase
    balanced over the domains; folds 0-1, row for row."""
    from tests.test_torch_skill import stitch_table
    stitch, sdf = _both(tmp_path, stitch_table(n_videos=24), "stitch.csv")
    ns, ndf = _both(tmp_path, _ns_timestamps(), "ns.csv")
    for fold in range(2):
        got, gcls = ref.ns_vs_vua_tables(stitch, ns, fold,
                                         training_fraction=fraction)
        want, wcls = jref.ns_vs_vua_tables(sdf, ndf, fold,
                                           training_fraction=fraction)
        assert gcls == wcls == ["NS", "VUA"]
        for ph in ("train", "val", "test"):
            _same(got[ph], want[ph])
        assert {r["Domain"] for r in got["train"]} == {"NS", "VUA"}


class _Store:
    def __init__(self, n, d, seed):
        rng = np.random.default_rng(seed)
        self.videos = {}
        self.n, self.d, self.rng = n, d, rng

    def read_video(self, name):
        if name not in self.videos:
            self.videos[name] = self.rng.standard_normal(
                (self.n, self.d)).astype(np.float32)
        return self.videos[name]


def test_ns_vs_vua_batches_and_frame_cap_match_jax():
    """ns_vs_vua_batches over a DomainKeyedStore of two domains' stores
    (fixed stride 10, the 2000-frame cap, NS = 0 / VUA = 1, buckets to
    2000, TTA variants) equals the JAX package's batch for batch, bit for
    bit; frame_cap keeps the first 2000 indices."""
    from sais_tpu.config import WindowConfig as JWindow
    from sais_tpu_torch.config import WindowConfig
    rows = [{"Video": f"{dom}{i}", "Domain": dom, "StartFrame": s,
             "EndFrame": s + span}
            for i, (dom, s, span) in enumerate(
                [("NS", 5, 40), ("VUA", 100, 4000), ("NS", 7, 300),
                 ("VUA", 1, 150), ("NS", 50, 22000)])]
    domains = {r["Video"]: r["Domain"] for r in rows}
    stores = {d: _Store(30000, 8, seed) for d, seed in (("NS", 0),
                                                        ("VUA", 1))}
    jstores = {d: _Store(30000, 8, seed) for d, seed in (("NS", 0),
                                                         ("VUA", 1))}
    got = list(ref.ns_vs_vua_batches(
        rows, ref.DomainKeyedStore(stores, domains), None, WindowConfig(),
        2, True, seed=3, tta=True))
    want = list(jref.ns_vs_vua_batches(
        pd.DataFrame(rows), jref.DomainKeyedStore(jstores, domains), None,
        JWindow(), 2, True, seed=3, tta=True))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for gv, wv in zip(g["tta"], w["tta"]):
            assert gv.keys() == wv.keys()
            for k in wv:
                np.testing.assert_array_equal(gv[k], wv[k], err_msg=k)
    idx = np.arange(5000)
    np.testing.assert_array_equal(ref.frame_cap(idx), jref.frame_cap(idx))
    np.testing.assert_array_equal(ref.frame_cap(idx, 7),
                                  jref.frame_cap(idx, 7))


def test_gesture_inference_tables_match_pandas(tmp_path):
    """Gronau (random_state 1) and RAPN (0): 3 rows sampled per (PID,
    gesture) with >= 3 examples after the cleanup and the 10-frame
    filter; CinVivo: 0.5 s windows over each (category, label) group in
    sorted order, short groups giving none.  Row for row."""
    rows = _ns_timestamps(seed=6, nvideos=6, per_video=40)
    rng = np.random.default_rng(7)
    for r in rows:
        r["PID"] = int(rng.integers(1, 5))
    rows, df = _both(tmp_path, rows)
    for fn in ("gronau_gesture_inference_table",
               "rapn_gesture_inference_table"):
        _same(getattr(ref, fn)(rows), getattr(jref, fn)(df))
    _same(ref.gronau_gesture_inference_table(rows, ("p", "x")),
          jref.gronau_gesture_inference_table(df, ("p", "x")))
    paths = [{"category": c, "label": lab, "path": f"f{i}.jpg"}
             for i, (c, lab) in enumerate(
                 [("b", "x")] * 47 + [("a", "y")] * 14 + [("a", "z")] * 31
                 + [("b", "w")] * 15)]
    prow, pdf = _both(tmp_path, paths, "paths.csv")
    _same(ref.cinvivo_inference_table(prow),
          jref.cinvivo_inference_table(pdf).reset_index(drop=True))
