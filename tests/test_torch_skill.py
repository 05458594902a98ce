"""The port's skill path (data and model) against the JAX package and
pandas on the CPU: the sampling policies, the pandas-free EASE tables
(duration filter, fold split, explanations and importance targets, -bg /
-sg group balancing over the USC meta table, the stitch sub-phase tables,
the cross-hospital inference tables), collation with TTA, flow and the
multi-task domains, the importance losses, the importance and linearB
heads, and PrototypeTrainer(use_importance=True) against the JAX trainer.
Rows must be equal to pandas' and in the same order; the JAX trainer's
flash path runs its Pallas kernels in interpret mode."""

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from sais_tpu import config as jconfig
from sais_tpu.data import reference_datasets as jref
from sais_tpu.data import skill as jskill
from sais_tpu.data import tasks as jtasks
from sais_tpu.models import full_model as jfm
from sais_tpu.train import losses as jlosses
from sais_tpu.train.loop import PrototypeTrainer as JaxTrainer
from sais_tpu_torch import config as tconfig
from sais_tpu_torch.data import datasets
from sais_tpu_torch.data import reference_datasets as ref
from sais_tpu_torch.data import skill
from sais_tpu_torch.data import tasks
from sais_tpu_torch.models.full_model import FullModel, prototypes_forward
from sais_tpu_torch.port.weights import full_model_params_from_jax
from sais_tpu_torch.train import losses
from sais_tpu_torch.train.loop import PrototypeTrainer

DIM = 32
TEMP = dict(rep_dim=DIM, num_layers=2, num_heads=4, ffn_dim=64,
            max_positions=160)
RACES = (("Needle Handling", "# Repositions"),
         ("Needle Driving", "Driving Sequence"),
         ("Needle Withdrawal", "Wrist Rotation"))
NFRAMES = 800


# ---------------------------------------------------------------------------
# Synthetic EASE tables, written as CSV and read by both packages
# ---------------------------------------------------------------------------

def stitch_table(n_videos=16, stitches=4, seed=0):
    """VUA_EASE_Stitch_Paths.csv-schema rows over the three RACE/EASE
    pairs: Files 102 / 372 (excluded by the reference), a 'P-' videoname,
    spans too short for the duration filter, rows of another EASE metric,
    an empty cell in a frame column the row's RACE does not read (the
    column is then float) and a text column with empty cells."""
    rng = np.random.default_rng(seed)
    rows = []
    for v in range(n_videos):
        file = (102, 372)[v] if v < 2 else 200 + v
        for s in range(stitches):
            start = int(rng.integers(30, 300))
            entry = start + int(rng.integers(12, 120))
            wd = entry + int(rng.integers(5, 90))
            wd_end = wd + int(rng.integers(60, 160))
            for race, ease in RACES:
                rows.append({
                    "File": file, "Stitch": s,
                    "Path": (f"C:\\data\\vid{v}" if v % 2 else
                             f"/data/vid{v}"),
                    "videoname": f"P-{v}" if v == 3 else f"case{v}",
                    "Anatomy": "Posterior" if s % 2 else "Anterior",
                    "RACE": race,
                    "EASE": ease if rng.random() > 0.08 else "Other",
                    "maj": int(rng.integers(0, 3)),
                    "Needle Handling Start Frame": start,
                    "Needle Entry Start Frame": entry,
                    "Needle Withdrawal Start Frame": wd,
                    "Needle Withdrawal End Frame": (
                        "" if race == "Needle Handling" and s == 1
                        else wd_end),
                    "Notes": "" if rng.random() < 0.5 else f"n{s}"})
    return rows


def explanation_tables(stitch, seed=1):
    """Two EASE_Explanations-schema tables: a (File, Stitch) explained
    twice, one not at all, empty Start4-6 / End4-6 cells, a row of another
    hospital."""
    rng = np.random.default_rng(seed)
    keys = list(dict.fromkeys((r["File"], r["Stitch"]) for r in stitch))
    tables = [[], []]
    for i, (file, s) in enumerate(keys):
        if i % 7 == 3:
            continue                       # no explanation
        for phase in ("NH", "ND", "NW"):
            for rep in range(2 if i % 5 == 1 else 1):
                row = {"File Number": file, "Stitch": s,
                       "Suturing Phase": phase,
                       "Hospital": "COH" if i % 11 == 4 else "USC"}
                for n in range(1, 7):
                    a = int(rng.integers(0, 90))
                    empty = n > 3 and rng.random() < 0.5
                    row[f"Start{n} Frame"] = "" if empty else a
                    row[f"End{n} Frame"] = "" if empty else \
                        a + int(rng.integers(5, 30))
                tables[(i + rep) % 2].append(row)
    return tables


def meta_table(stitch, seed=2):
    """USC surgeon / patient meta rows: one per (CaseID, TaskID) plus a
    duplicate, a case without meta, an empty surgery date."""
    rng = np.random.default_rng(seed)
    rows = []
    files = list(dict.fromkeys(r["File"] for r in stitch))
    for i, file in enumerate(files):
        if i == 5:
            continue
        for task in (11, 12):
            year = int(rng.integers(2015, 2021))
            rows.append({
                "CaseID": file, "TaskID": task,
                "Surgery Date": "" if i == 7 and task == 11 else
                f"{int(rng.integers(1, 13))}/{int(rng.integers(1, 29))}/"
                f"{year}",
                **{f"{y} Robotic Cases": int(rng.integers(20, 200))
                   for y in (2016, 2017, 2018, 2019)},
                "Prostate volume": float(rng.integers(20, 90)),
                "Age": float(rng.integers(45, 80)),
                "BMI": round(float(rng.uniform(20, 36)), 1)})
    rows.append(dict(rows[0], Age=99.0))     # a duplicate key: dropped
    return rows


def write_csv(path, rows):
    pd.DataFrame(rows).to_csv(path, index=False)
    return str(path)


def same(a, b):
    if isinstance(a, (list, np.ndarray)) or isinstance(b, (list,
                                                           np.ndarray)):
        return np.array_equal(np.asarray(a), np.asarray(b))
    if datasets.isna(a) or a is pd.NaT:
        return datasets.isna(b) or b is pd.NaT
    return a == b


def assert_rows(got, df, columns=True):
    """Port rows == the DataFrame's records, in order (NaN == NaN)."""
    want = df.to_dict("records")
    assert len(got) == len(want)
    if columns and want:
        assert list(got[0]) == list(df.columns)
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), (i, set(g) ^ set(w))
        for k in w:
            assert same(g[k], w[k]), (i, k, g[k], w[k])


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """The synthetic tables, each read from CSV by pandas and by the port."""
    d = tmp_path_factory.mktemp("ease")
    stitch = stitch_table()
    paths = {"stitch": write_csv(d / "stitch.csv", stitch),
             "meta": write_csv(d / "meta.csv", meta_table(stitch))}
    for i, t in enumerate(explanation_tables(stitch)):
        paths[f"expl{i}"] = write_csv(d / f"expl{i}.csv", t)
    return {k: (pd.read_csv(p), datasets.read_segments(p))
            for k, p in paths.items()}


# ---------------------------------------------------------------------------
# Policies, reading, filters, splits
# ---------------------------------------------------------------------------

POLICIES = {"GESTURE": "GESTURE_POLICY", "AFB": "AFB_HANDLING_POLICY",
            "USC": "STITCH_USC_POLICY", "NS": "NS_VS_VUA_POLICY",
            **{f"RACE:{r}": ("RACE_POLICIES", r) for r, _ in RACES},
            **{f"TRAIN:{r}": ("STITCH_TRAIN_POLICIES", r) for r, _ in RACES},
            **{f"INF:{r}": ("STITCH_INFERENCE_POLICIES", r)
               for r, _ in RACES}}


def _policy(module, spec):
    if isinstance(spec, tuple):
        return getattr(module, spec[0])[spec[1]]
    return getattr(module, spec)


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_policy_indices_match_jax(name):
    """policy_indices bitwise for every policy and TTA offset, over spans
    from empty to 3,000 frames, negative starts included (numpy's wrap)."""
    got_p, want_p = (_policy(m, POLICIES[name]) for m in (tasks, jtasks))
    assert got_p == tasks.SamplingPolicy(**vars(want_p))
    rng = np.random.default_rng(len(name))
    for _ in range(60):
        s = int(rng.integers(-50, 400))
        e = s + int(rng.integers(0, 3000))
        assert tasks.race_window(s, e) == jtasks.race_window(s, e)
        for off in (0, 3, 6):
            got = tasks.policy_indices(s, e, got_p, off)
            want = jtasks.policy_indices(s, e, want_p, off)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


FLOW_PHASES = (*jskill.EASE_INFERENCE_PHASES, "train", "val", "test",
               "inference", "Custom_inference", "HMH_train")


def _outcome(fn):
    try:
        return fn()
    except (KeyError, ValueError) as e:
        return type(e)


@pytest.mark.parametrize("phase", FLOW_PHASES)
def test_flow_jump_matches_jax(phase):
    """_flow_jump for every phase, for tabled and unknown videos, with and
    without the row's RGB stride: the same jump, or the same KeyError /
    ValueError."""
    table = {"vid1": 30.0, "vid2": 59.94}
    for video in ("1", "vid1", "vid2", "HMV4", "HMV23", "nope"):
        for stride in (None, 0, 7):
            for fps in (None, table):
                kw = {} if fps is None else {"fps_table": fps}
                got = _outcome(lambda: skill._flow_jump(
                    video, phase=phase, rgb_stride=stride, **kw))
                want = _outcome(lambda: jskill._flow_jump(
                    video, phase=phase, rgb_stride=stride, **kw))
                assert got == want, (video, stride, fps)


def test_read_segments_reads_empty_cells_as_pandas_does(tables):
    """An empty cell is NaN and a column of ints with empty cells is float,
    as pd.read_csv types them (the EASE tables' empty Start4-6 / End4-6
    cells, the stitch table's empty frame and text cells)."""
    for name, (df, rows) in tables.items():
        assert_rows(rows, df)
        for col in df.columns:
            kinds = {type(r[col]) for r in rows if not datasets.isna(r[col])}
            if df[col].dtype.kind == "f":
                assert kinds <= {float}, (name, col, kinds)
            elif df[col].dtype.kind == "i":
                assert kinds == {int}, (name, col, kinds)
            else:
                assert kinds <= {str}, (name, col, kinds)
    stitch = tables["stitch"][1]
    assert isinstance(stitch[0]["Needle Withdrawal End Frame"], float)


def test_duration_filter_and_video_split_match_jax(tables):
    df, rows = tables["stitch"]
    df = df.assign(Video=df["Path"].apply(jskill.video_name)
                   if hasattr(jskill, "video_name") else
                   df["Path"].apply(lambda p: p.split("\\")[-1]
                                    if "\\" in p else p.split("/")[-1]))
    rows = skill.with_video(rows)
    assert_rows(skill.duration_filter(rows), jskill.duration_filter(df))
    for abbrev in ("NH", "ND", "NW"):
        assert_rows(skill.race_and_ease_filter(rows, abbrev),
                    jskill.race_and_ease_filter(df, abbrev))
    for fold in range(5):
        for got, want in zip(skill.ease_video_split(rows, fold),
                             jskill.ease_video_split(df, fold)):
            assert_rows(got, want)


# ---------------------------------------------------------------------------
# Explanations and importance targets
# ---------------------------------------------------------------------------

def _train_split(tables, domain="NH_02", fold=0):
    """The train rows attach_importance receives in build_ease_dataset."""
    df, rows = tables["stitch"]
    race = domain.split("_")[0]
    labels = [int(c) for c in domain.split("_")[1]]
    df = df[~df["File"].isin([102, 372])].copy()
    df["Video"] = df["Path"].apply(lambda p: p.split("\\")[-1] if "\\" in p
                                   else p.split("/")[-1])
    df = jskill.race_and_ease_filter(jskill.duration_filter(df), race)
    df = df[df["maj"].isin(labels)]
    rows = skill.with_video([r for r in rows if r["File"] not in (102, 372)])
    rows = [r for r in skill.race_and_ease_filter(
        skill.duration_filter(rows), race) if r["maj"] in labels]
    return jskill.ease_video_split(df, fold)[0], \
        skill.ease_video_split(rows, fold)[0]


@pytest.mark.parametrize("domain", ["NH_02", "ND_012", "NW_12"])
@pytest.mark.parametrize("groups", [False, True])
def test_attach_importance_matches_jax(tables, domain, groups):
    """load_explanations and attach_importance: low rows repeated once per
    matching explanation, missing explanations and empty spans as zeros,
    the outer merge's sort over every shared column, '_merge'; with -bg
    (`groups`), after balance_groups renamed File to CaseID, so the shared
    columns change and the categorical meta columns sort by code."""
    expl_df = [tables["expl0"][0], tables["expl1"][0]]
    expl = [tables["expl0"][1], tables["expl1"][1]]
    want_e = jskill.load_explanations(expl_df, domain)
    got_e = skill.load_explanations(expl, domain)
    assert_rows(got_e, want_e)
    tr_df, tr = _train_split(tables, domain)
    if groups:
        meta_df = jref.prepare_usc_meta(tables["meta"][0])
        meta = ref.prepare_usc_meta(tables["meta"][1])
        tr_df = jref.balance_groups(tr_df, meta_df, "Patient Age Group")
        tr = ref.balance_groups(tr, meta, "Patient Age Group")
        assert_rows(tr, tr_df)
    want = jskill.attach_importance(tr_df, want_e)
    got = skill.attach_importance(tr, got_e)
    assert_rows(got, want)
    assert any(r["_merge"] == "right_only" for r in got)
    assert any(isinstance(r["frame importance"], list) and
               1 in r["frame importance"] for r in got)


def test_attach_importance_without_low_rows_raises_like_jax(tables):
    tr_df, tr = _train_split(tables, "NH_02")
    tr_df = tr_df[tr_df["maj"] == 2]
    tr = [r for r in tr if r["maj"] == 2]
    expl_df = jskill.load_explanations([tables["expl0"][0]], "NH_02")
    with pytest.raises(ValueError):
        jskill.attach_importance(tr_df, expl_df)
    with pytest.raises(ValueError):
        skill.attach_importance(tr, skill.load_explanations(
            [tables["expl0"][1]], "NH_02"))


# ---------------------------------------------------------------------------
# Meta table, group balancing, datasets
# ---------------------------------------------------------------------------

def test_prepare_usc_meta_matches_pandas(tables):
    """pd.to_datetime (one inferred format; empty -> NaT), the caseload
    lookup, pd.cut right-closed at [0, 100, inf] and pd.qcut at the
    median (linear interpolation, lowest included): the same rows, the
    group labels with pandas' category order; a date of another format
    raises in both."""
    df, rows = tables["meta"]
    want = jref.prepare_usc_meta(df)
    got = ref.prepare_usc_meta(rows)
    assert_rows(got, want)
    for col in ("Caseload Group", "Prostate Volume Group",
                "Patient Age Group", "Patient BMI Group"):
        cats = list(want[col].cat.categories)
        assert all(r[col].categories == tuple(cats) for r in got
                   if not datasets.isna(r[col])), col
    bad_df = df.copy()
    bad_df.loc[3, "Surgery Date"] = "2017-31-12"
    bad = [dict(r) for r in rows]
    bad[3]["Surgery Date"] = "2017-31-12"
    with pytest.raises(ValueError):
        jref.prepare_usc_meta(bad_df)
    with pytest.raises(ValueError):
        ref.prepare_usc_meta(bad)
    edge = {"Caseload": [-1, 0, 1, 100, 101], "x": [3.0, 1.0, 2.0, 2.0, 9.0]}
    cut = pd.cut(pd.Series(edge["Caseload"]), [0, 100, float("inf")],
                 labels=["novice", "expert"]).tolist()
    assert [same(a, b) for a, b in zip(
        ref.cut(edge["Caseload"], [0, 100, float("inf")],
                ["novice", "expert"]), cut)] == [True] * 5
    qcut = pd.qcut(pd.Series(edge["x"]), [0, 0.5, 1],
                   labels=["lo", "hi"]).tolist()
    assert ref.qcut(edge["x"], [0, 0.5, 1], ["lo", "hi"]) == qcut


DATASET_CASES = {
    "single": dict(domain="NH_02"),
    "two-domains": dict(domain="NH_02+ND_02"),
    "no-balance": dict(domain="ND_012", balance=False),
    "importance": dict(domain="NH_02", importance_loss=True),
    "importance-two-domains": dict(domain="NH_02+NW_02",
                                   importance_loss=True),
    "groups": dict(domain="NH_02", importance_loss=True, group="Caseload Group"),
    "single-group": dict(domain="ND_02", group="Patient BMI Group",
                         group_val="≤28"),
}


@pytest.mark.parametrize("case", sorted(DATASET_CASES))
def test_build_ease_dataset_matches_jax(tables, case):
    kw = dict(DATASET_CASES[case])
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("importance_loss"):
        jkw["explanations"] = [tables["expl0"][0], tables["expl1"][0]]
        tkw["explanations"] = [tables["expl0"][1], tables["expl1"][1]]
    if "group" in kw:
        jkw["meta"] = jref.prepare_usc_meta(tables["meta"][0])
        tkw["meta"] = ref.prepare_usc_meta(tables["meta"][1])
    for fold in (0, 2):
        want, wcls = jskill.build_ease_dataset(tables["stitch"][0],
                                               fold=fold, **jkw)
        got, gcls = skill.build_ease_dataset(tables["stitch"][1], fold=fold,
                                             **tkw)
        assert gcls == wcls
        for phase in ("train", "val", "test"):
            assert_rows(got[phase], want[phase])


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_stitch_phase_tables_match_jax(tables, fraction):
    for fold in (0, 1):
        want, wcls = jref.stitch_phase_tables(tables["stitch"][0], fold,
                                              fraction)
        got, gcls = ref.stitch_phase_tables(tables["stitch"][1], fold,
                                            fraction)
        assert gcls == wcls
        for phase in ("train", "val", "test"):
            assert_rows(got[phase], want[phase])


@pytest.mark.parametrize("phase", jskill.EASE_INFERENCE_PHASES)
def test_ease_inference_table_matches_jax(tmp_path, phase):
    """The seven cross-hospital phase tables: maj remapped {0,1,2} ->
    {0,0,2}, 5 high rows a video (pandas' sample), the final balance in
    first-appearance class order, Gronau_full without Domain, the USC
    phase's File / 'P-' / duration filters."""
    rows = stitch_table(n_videos=10, stitches=12, seed=5)
    for r in rows:      # 7 high-skill stitches a video, then maj 0 / 1
        r["maj"] = 2 if r["Stitch"] < 7 else r["Stitch"] % 2
    path = write_csv(tmp_path / "stitch.csv", rows)
    df, rows = pd.read_csv(path), datasets.read_segments(path)
    for domain in ("NH_02", "ND_02", "NW_02"):
        for videos in (None, [f"vid{v}" for v in range(0, 10, 2)]):
            want = jskill.ease_inference_table(df, phase, domain, videos)
            got = skill.ease_inference_table(rows, phase, domain, videos)
            assert len(want)
            assert_rows(got, want)


def test_ease_inference_table_sample_needs_five_high_rows(tables):
    df, rows = tables["stitch"]
    small_df = df[df["Path"].str.endswith("vid4")]
    small = [r for r in rows if r["Path"].endswith("vid4")]
    with pytest.raises(ValueError):
        jskill.ease_inference_table(small_df, "COH_inference", "NH_02")
    with pytest.raises(ValueError):
        skill.ease_inference_table(small, "COH_inference", "NH_02")


# ---------------------------------------------------------------------------
# Collation
# ---------------------------------------------------------------------------

class _Store:
    def __init__(self, videos):
        self.videos = videos
        self.reads = 0

    def read_video(self, name):
        self.reads += 1
        return self.videos[name]


def _stores(dim=8, seed=3):
    rng = np.random.default_rng(seed)
    rgb = {f"vid{v}": rng.standard_normal((NFRAMES, dim)).astype(np.float32)
           for v in range(16)}
    flow = {k: rng.standard_normal((NFRAMES, dim)).astype(np.float32)
            for k in rgb}
    return rgb, flow


SKILL_BATCH_CASES = {
    "tta": dict(domain="NH_012", phase="val", tta=True, split="train"),
    "importance": dict(domain="NH_02", phase="train", importance_loss=True,
                       shuffle=True),
    "two-domains": dict(domain="NH_02+ND_02", phase="train", shuffle=True,
                        importance_loss=True),
    "flow": dict(domain="ND_012", phase="train", tta=True, flow=True),
    "flow-inference": dict(domain="NW_02", phase="COH_inference", tta=True,
                           flow=True, split="train"),
    "stitch": dict(domain="stitch", phase="train", shuffle=True, flow=True),
}


@pytest.mark.parametrize("case", sorted(SKILL_BATCH_CASES))
def test_skill_batches_match_jax(tables, case):
    """skill_batches / collate_skill: every array bitwise (rgb, masks,
    labels, importance targets and ipad, flow rows by unique(idx // jump)
    unclipped, primary_domain), each TTA variant, one store read per video
    per batch."""
    kw = {"shuffle": False, **SKILL_BATCH_CASES[case]}
    domain, phase = kw.pop("domain"), kw.pop("phase")
    split = kw.pop("split", phase)
    use_flow = kw.pop("flow", False)
    rgb, flow = _stores()
    fps = {f"vid{v}": 20.0 + 5 * (v % 3) for v in range(16)}
    if domain == "stitch":
        want_t, classes = jref.stitch_phase_tables(tables["stitch"][0], 0)
        got_t, _ = ref.stitch_phase_tables(tables["stitch"][1], 0)
        extra = dict(label_fn=lambda row: classes.index(row["EASE"]),
                     branch="stitch")
        domain = "NH_vs_ND_vs_NW"
    else:
        il = kw.get("importance_loss", False)
        want_t, classes = jskill.build_ease_dataset(
            tables["stitch"][0], domain, 0, importance_loss=il,
            explanations=[tables["expl0"][0], tables["expl1"][0]])
        got_t, _ = skill.build_ease_dataset(
            tables["stitch"][1], domain, 0, importance_loss=il,
            explanations=[tables["expl0"][1], tables["expl1"][1]])
        extra = {}
    stores = [_Store(rgb), _Store(flow) if use_flow else None]
    bs = 6 if phase == "train" else 2
    want = list(jskill.skill_batches(
        want_t[split], *stores, classes, domain, phase, bs, seed=4,
        fps_table=fps, **kw, **extra))
    reads = stores[0].reads
    stores[0].reads = 0
    got = list(skill.skill_batches(
        got_t[split], *stores, classes, domain, phase, bs, seed=4,
        fps_table=fps, **kw, **extra))
    assert stores[0].reads == reads
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for gv, wv in zip([g, *g.get("tta", [])], [w, *w.get("tta", [])]):
            assert set(gv) - {"tta"} == set(wv) - {"tta"}
            for key in set(wv) - {"tta"}:
                assert gv[key].dtype == wv[key].dtype, key
                np.testing.assert_array_equal(gv[key], wv[key], key)
    if kw.get("importance_loss"):
        assert any(b["importance"].any() for b in got)
    if "+" in domain:
        assert any(not b["primary_domain"].all() for b in got)


def test_collate_skill_raises_past_the_last_bucket(tables):
    """Skill windows longer than 128 frames raise in collate_skill (the
    assessor grows its buckets instead); the flow buckets start at 2."""
    row = dict(tables["stitch"][1][0], Video="vid2", RACE="Needle Driving",
               maj=0, **{"Needle Entry Start Frame": 10,
                         "Needle Withdrawal Start Frame": 1700})
    rgb, _ = _stores()
    store = _Store({"vid2": np.zeros((2000, 8), np.float32)})
    for fn in (skill.collate_skill, jskill.collate_skill):
        rows = [row] if fn is skill.collate_skill else pd.DataFrame([row])
        with pytest.raises(ValueError, match="exceeds largest bucket"):
            fn(rows, store, None, [0, 2], "ND_02", "train")
    assert skill.bucket_for(3, [2, 4, 8, 16]) == 4


# ---------------------------------------------------------------------------
# Importance losses, heads, trainer
# ---------------------------------------------------------------------------

def _loss_inputs(seed, b=6, f=9, low=True):
    rng = np.random.default_rng(seed)
    scores = rng.standard_normal((b, 1, f + 1, 1)).astype(np.float32) * 2
    targets = (rng.random((b, 1, f)) < 0.4).astype(np.float32)
    ipad = np.zeros((b, 1, f + 1), bool)
    for i in range(b):
        ipad[i, 0, f + 1 - i:] = True
    labels = rng.integers(0, 3, b).astype(np.int32)
    if not low:
        labels[labels == 0] = 1
    weight = (rng.random(b) < 0.7).astype(np.float32)
    return scores, targets, ipad, labels, weight


@pytest.mark.parametrize("fn,weighted", [
    ("importance_loss_reference", False), ("importance_loss_reference", True),
    ("masked_importance_loss", False)])
def test_importance_losses_match_jax(fn, weighted):
    """The calcImportanceLoss quirk (BCE reduced to one scalar before the
    mask, so every row's scores get a gradient, padded and high-skill rows
    included) and the intended masked BCE: values and gradients within
    rtol 1e-5 of jax.grad."""
    for seed in range(4):
        s, t, ipad, lab, w = _loss_inputs(seed)
        extra = ({"weight": w} if weighted else {})
        jf = getattr(jlosses, fn)
        tf = getattr(losses, fn)
        want, jgrad = jax.value_and_grad(lambda x: jf(
            x, jnp.asarray(t), jnp.asarray(ipad), jnp.asarray(lab),
            **{k: jnp.asarray(v) for k, v in extra.items()}))(jnp.asarray(s))
        x = torch.tensor(s, requires_grad=True)
        got = tf(x, torch.tensor(t), torch.tensor(ipad), torch.tensor(lab),
                 **{k: torch.tensor(v) for k, v in extra.items()})
        got.backward()
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad),
                                   rtol=1e-5, atol=1e-8)
        if fn == "importance_loss_reference" and not weighted:
            # the quirk: padded slots and high-skill rows get gradient too
            assert (x.grad[:, :, 1:] != 0).all()


def test_importance_loss_without_low_rows():
    """No low-skill row: the loss is 0 in both packages.  JAX's gradient is
    NaN there (the 0 / 0 of its unselected jnp.where branch); the port's is
    0, the gradient of the value both return."""
    s, t, ipad, lab, _ = _loss_inputs(7, low=False)
    args = (jnp.asarray(t), jnp.asarray(ipad), jnp.asarray(lab))
    want, jgrad = jax.value_and_grad(
        lambda x: jlosses.importance_loss_reference(x, *args))(
            jnp.asarray(s))
    x = torch.tensor(s, requires_grad=True)
    got = losses.importance_loss_reference(x, torch.tensor(t),
                                           torch.tensor(ipad),
                                           torch.tensor(lab))
    got.backward()
    assert float(got) == float(want) == 0.0
    assert np.isnan(np.asarray(jgrad)).any()
    assert (x.grad == 0).all()


def _model_cfgs(importance=True, multi=False, use_flash=None, nclasses=2,
                modalities="RGB"):
    kw = dict(rep_dim=DIM, proj_dim=16, nclasses=nclasses,
              modalities=modalities, importance_head=importance,
              multi_task=multi)
    return (jconfig.ModelConfig(**kw, temporal=jconfig.TemporalConfig(
                **TEMP, use_flash=use_flash)),
            tconfig.ModelConfig(**kw, temporal=tconfig.TemporalConfig(
                **TEMP, use_flash=use_flash)))


def _model_pair(jcfg, cfg, seed=0):
    params = jfm.full_model_init(jax.random.key(seed), jcfg)
    model = FullModel(cfg)
    model.load_state_dict(full_model_params_from_jax(params))
    return params, model


@pytest.mark.parametrize("modalities", ["RGB", "RGB-Flow"])
def test_prototypes_forward_importance_and_linearB_match_jax(modalities):
    """The importance head over the full sequence (CLS slot included) and
    the multi-task linearB routing by primary_domain, within 1e-4; without
    a linearB head primary_domain raises JAX's ValueError."""
    jcfg, cfg = _model_cfgs(multi=True, modalities=modalities)
    params, model = _model_pair(jcfg, cfg)
    rng = np.random.default_rng(0)
    b, f = 5, 12
    rgb = rng.standard_normal((b, 1, f, DIM)).astype(np.float32)
    mask = np.zeros((b, 1, f + 1), bool)
    mask[1, 0, 9:] = True
    flow = rng.standard_normal((b, 1, 4, DIM)).astype(np.float32)
    fmask = np.zeros((b, 1, 5), bool)
    primary = np.array([True, False, True, False, False])
    fl = modalities != "RGB"
    want = jfm.prototypes_forward(
        params, jcfg, jnp.asarray(rgb), jnp.asarray(mask),
        jnp.asarray(flow) if fl else None, jnp.asarray(fmask) if fl else None,
        primary_domain=jnp.asarray(primary))
    with torch.no_grad():
        got = prototypes_forward(
            model, cfg, torch.tensor(rgb), torch.tensor(mask),
            torch.tensor(flow) if fl else None,
            torch.tensor(fmask) if fl else None,
            primary_domain=torch.tensor(primary))
    for name in ("video_rep", "aux_logits", "attn", "importances"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=1e-4, err_msg=name)
    assert got.importances.shape == (b, 1, f + 1, 1)
    jcfg1, cfg1 = _model_cfgs(multi=False, importance=False)
    _, plain = _model_pair(jcfg1, cfg1)
    out = prototypes_forward(plain, cfg1, torch.tensor(rgb),
                             torch.tensor(mask))
    assert out.importances is None and plain.linearB is None
    with pytest.raises(ValueError, match="linearB"):
        prototypes_forward(plain, cfg1, torch.tensor(rgb),
                           torch.tensor(mask),
                           primary_domain=torch.tensor(primary))


def _skill_trainer_batches(tables, domain, n=3):
    rgb, _ = _stores(dim=DIM)
    data, classes = skill.build_ease_dataset(
        tables["stitch"][1], domain, 0, importance_loss=True,
        explanations=[tables["expl0"][1], tables["expl1"][1]])
    train = list(skill.skill_batches(data["train"], _Store(rgb), None,
                                     classes, domain, "train", 6,
                                     shuffle=True, importance_loss=True))
    val = list(skill.skill_batches(data["val"] + data["test"], _Store(rgb),
                                   None, classes, domain, "val", 6,
                                   shuffle=False, tta=True))
    return train[:n], val, classes


def _trainer_pair(domain, use_flash, lr=0.05):
    nclasses = 4 if "+" in domain else 2
    jcfg, cfg = _model_cfgs(multi="+" in domain, use_flash=use_flash,
                            nclasses=nclasses)
    params, model = _model_pair(jcfg, cfg)
    keys, protos = jfm.prototypes_init(jax.random.key(1), nclasses, 16)
    jtr = JaxTrainer(jcfg, jconfig.TrainConfig(lr=lr, importance_loss=True),
                     params, keys, protos)
    tr = PrototypeTrainer(cfg, tconfig.TrainConfig(lr=lr,
                                                   importance_loss=True),
                          model, keys, torch.tensor(np.asarray(protos)),
                          device="cpu")
    assert tr.use_importance
    return jtr, tr


@pytest.mark.parametrize("domain,use_flash", [("NH_02", False),
                                              ("NH_02", True),
                                              ("NH_02+ND_02", False)])
def test_importance_trainer_steps_match_jax(tables, domain, use_flash):
    """PrototypeTrainer(use_importance=True) steps on EASE batches with
    importance targets (and, for A+B, the linearB rows): the same losses
    and the same parameters after, within 1e-4 of the JAX trainer; with
    flash on, K2's and K3's plain versions against the Pallas kernels in
    interpret mode, K3 fed a cotangent on every query row of the last
    layer (the importance loss reads them all, padded rows included)."""
    train, _, _ = _skill_trainer_batches(tables, domain)
    assert any(b["importance"].any() for b in train)
    jtr, tr = _trainer_pair(domain, use_flash)
    for batch in train:
        jl, _ = jtr.run_epoch([batch], train=True)
        gl, _ = tr.run_epoch([batch], train=True)
        assert abs(gl - jl) <= 1e-4
    want = full_model_params_from_jax(jax.tree.map(np.asarray,
                                                   jtr.state.model))
    for name, p in tr.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0,
                                   atol=1e-4, err_msg=name)
    np.testing.assert_allclose(tr.prototypes.detach().numpy(),
                               np.asarray(jtr.state.prototypes), atol=1e-4)


def test_importance_fit_matches_jax(tables):
    """fit with the importance loss at train steps only (val and test run
    the NCE loss over 3 TTA variants): the same val history and best epoch
    as the JAX trainer, losses within 1e-4."""
    train, val, _ = _skill_trainer_batches(tables, "NH_02", n=2)
    jtr, tr = _trainer_pair("NH_02", False, lr=0.2)
    loaders = {"train": lambda epoch=0: iter(train),
               "val": lambda epoch=0: iter(val)}
    want = jtr.fit(loaders, nepochs=3, log=lambda s: None)
    got = tr.fit(loaders, nepochs=3, log=lambda s: None)
    assert got["best_epoch"] == want["best_epoch"]
    np.testing.assert_allclose(got["metrics"]["loss"],
                               want["metrics"]["loss"], atol=1e-4)
    np.testing.assert_allclose(got["prototypes"].numpy(),
                               np.asarray(want["prototypes"]), atol=1e-4)
