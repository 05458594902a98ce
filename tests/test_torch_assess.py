"""The port's skill assessment (`SkillAssessor`, `assess`) and the EASE
branches of `train` against the JAX package on the CPU.  The JAX CLI runs
in-process with `sais_tpu.config.PipelineConfig` monkeypatched to a tiny
temporal model (rep_dim 32, 2 layers), the port's with its own
`PipelineConfig` patched the same way; both read one H5 feature store.
Folds go both ways: the port's `train` writes folds that JAX's `assess`
reads and the reverse, and both `assess` commands write the same skill
CSV (index column, rows, probabilities within 1e-3) and the same
artifact pickles (keys, shapes, values within 1e-4)."""

import dataclasses
import os
import pickle
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

import jax

from sais_tpu import config as jconfig
from sais_tpu.cli.main import main as jax_main
from sais_tpu.infer.skill import SkillAssessor as JaxAssessor
from sais_tpu.models import full_model as jfm
from sais_tpu.train.checkpoint import save_training_result as jax_save
from sais_tpu_torch import config as tconfig
from sais_tpu_torch.cli import main as cli
from sais_tpu_torch.infer.skill import SkillAssessor
from sais_tpu_torch.io.feature_store import (FeatureStore, flow_store_path,
                                             rgb_store_path)
from sais_tpu_torch.models.full_model import FullModel
from sais_tpu_torch.port.weights import full_model_params_from_jax
from tests.test_torch_skill import (explanation_tables, meta_table,
                                    stitch_table, write_csv)

DIM = 32
NFRAMES = 800
VIDEOS = [f"vid{v}" for v in range(16)]


def _temporal(cfgmod, **kw):
    return cfgmod.TemporalConfig(**{**dict(rep_dim=DIM, num_layers=2,
                                           num_heads=4, ffn_dim=64,
                                           max_positions=512), **kw})


def tiny_pipeline(cfgmod):
    """PipelineConfig with the tiny temporal model (the CLIs' stand-in)."""
    cfg = cfgmod.PipelineConfig(model=cfgmod.ModelConfig(
        rep_dim=DIM, temporal=_temporal(cfgmod)))
    return lambda: cfg


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """Feature stores (RGB, and flow without a recorded jump so that each
    phase picks its own), the stitch, explanation and meta CSVs, and a
    JAX-initialized fold with the importance head under folds/Fold_0."""
    root = tmp_path_factory.mktemp("assess")
    rng = np.random.default_rng(0)
    for path in (rgb_store_path(str(root)), flow_store_path(str(root))):
        with FeatureStore(path, "a") as fs:
            for v in VIDEOS:
                fs.write_video(v, rng.standard_normal(
                    (NFRAMES, DIM)).astype(np.float32))
    stitch = stitch_table()
    write_csv(root / "stitch.csv", stitch)
    write_csv(root / "meta.csv", meta_table(stitch))
    for i, t in enumerate(explanation_tables(stitch)):
        write_csv(root / f"expl{i}.csv", t)
    jcfg = tiny_pipeline(jconfig)().model
    params = jfm.full_model_init(jax.random.key(5), dataclasses.replace(
        jcfg, importance_head=True))
    _, protos = jfm.prototypes_init(jax.random.key(6), 2)
    jax_save(str(root / "folds" / "Fold_0"),
             {"model": params, "prototypes": protos})
    return root


@pytest.fixture
def patched(monkeypatch):
    monkeypatch.setattr(jconfig, "PipelineConfig", tiny_pipeline(jconfig))
    monkeypatch.setattr(cli, "PipelineConfig", tiny_pipeline(tconfig))


# ---------------------------------------------------------------------------
# SkillAssessor
# ---------------------------------------------------------------------------

def _assessors(use_flash=None, modalities="RGB", seed=0):
    jcfg = jconfig.PipelineConfig(model=jconfig.ModelConfig(
        rep_dim=DIM, modalities=modalities, importance_head=True,
        temporal=_temporal(jconfig, use_flash=use_flash)))
    cfg = tconfig.PipelineConfig(model=tconfig.ModelConfig(
        rep_dim=DIM, modalities=modalities, importance_head=True,
        temporal=_temporal(tconfig, use_flash=use_flash)))
    params = jfm.full_model_init(jax.random.key(seed), jcfg.model)
    _, protos = jfm.prototypes_init(jax.random.key(seed + 1), 2)
    model = FullModel(cfg.model)
    model.load_state_dict(full_model_params_from_jax(params))
    return (JaxAssessor(params, protos, jcfg),
            SkillAssessor(model, torch.tensor(np.asarray(protos)), cfg,
                          device="cpu"))


def _video_rows(video):
    rows = [r for r in stitch_table() if r["Path"].endswith(video)
            and r["maj"] in (0, 1, 2)]
    for r in rows:
        r["Needle Withdrawal End Frame"] = r["Needle Withdrawal End Frame"] \
            or r["Needle Withdrawal Start Frame"] + 100
        r["Video"] = video
    return rows


ASSESS_CASES = {
    "dense": dict(phase="USC_inference"),
    "flash": dict(use_flash=True, phase="AFB_inference"),
    "rgb-flow": dict(modalities="RGB-Flow", phase="COH_inference"),
    "rgb-flow-lab": dict(modalities="RGB-Flow", phase="Lab_inference",
                         use_flash=True),
    "past-128": dict(phase="inference", long=True),
}


@pytest.mark.parametrize("case", sorted(ASSESS_CASES))
def test_skill_assessor_matches_jax(case):
    """reps and probabilities of every TTA offset, the first offset's
    attention (the dense (f+1, f+1) matrix, the flash path's CLS row) and
    importance (trimmed to f), within 1e-4 of the JAX assessor (its flash
    path in interpret mode); RGB-Flow with each phase's flow jump (the
    stale RGB stride, Lab's fixed 30), unclipped flow rows; a segment of
    136 frames grows the bucket to 256."""
    kw = dict(ASSESS_CASES[case])
    phase, long = kw.pop("phase"), kw.pop("long", False)
    jas, tas = _assessors(**kw)
    rng = np.random.default_rng(1)
    n = 3000 if long else NFRAMES
    rgb = rng.standard_normal((n, DIM)).astype(np.float32)
    flow = rng.standard_normal((n, DIM)).astype(np.float32)
    if long:
        rows = [{"Video": "v", "RACE": "Needle Driving", "StartFrame": 10,
                 "EndFrame": 1700},
                {"Video": "v", "RACE": "Needle Withdrawal", "StartFrame": 5,
                 "EndFrame": 400}]
    else:
        rows = _video_rows("vid6")[:5]
    use_flow = kw.get("modalities") == "RGB-Flow"
    want = jas.assess_segments(rgb, flow if use_flow else None,
                               pd.DataFrame(rows), phase=phase,
                               videoname="vid6")
    got = tas.assess_segments(rgb, flow if use_flow else None, rows,
                              phase=phase, videoname="vid6")
    assert sorted(got["reps"]) == sorted(want["reps"]) == [0, 1, 2]
    for key in ("reps", "probs"):
        for t in want[key]:
            np.testing.assert_allclose(np.stack(got[key][t]),
                                       np.stack(want[key][t]), atol=1e-4)
    assert len(got["attention"]) == len(got["importance"]) == len(rows)
    for g, w in zip(got["attention"], want["attention"]):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-4)
    for g, w in zip(got["importance"], want["importance"]):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-4 * max(np.abs(w).max(), 1))
    flash = kw.get("use_flash")
    assert all(a.ndim == (1 if flash else 2) for a in got["attention"])
    if long:
        assert got["importance"][0].shape == (136,)
        assert tas._bucket(136) == 256


def test_assessor_set_fold_and_missing_flow():
    jas, tas = _assessors(modalities="RGB-Flow")
    rows = _video_rows("vid4")[:1]
    with pytest.raises(ValueError, match="flow"):
        tas.assess_segments(np.zeros((NFRAMES, DIM), np.float32), None, rows)
    _, other = _assessors(seed=3)
    tas.set_fold(other.model, other.protos)
    assert tas.model is not other.model
    torch.testing.assert_close(tas.protos, other.protos)


# ---------------------------------------------------------------------------
# The CLI: assess
# ---------------------------------------------------------------------------

def _outputs(root, video, phase, nfolds=1):
    """(skill CSVs, artifact pickles) the last assess wrote."""
    csvs, arts = [], []
    for fold in range(nfolds):
        csvs.append(pd.read_csv(root / "results"
                                / f"{video}_skill_fold{fold}.csv",
                                index_col=0))
        d = root / "params" / f"Fold_{fold}"
        art = {}
        for name in ("reps_and_labels", "attention", "importance"):
            p = d / f"{name}_{phase}.pkl"
            if p.exists():
                with open(p, "rb") as f:
                    art[name] = pickle.load(f)
                os.remove(p)
        arts.append(art)
    return csvs, arts


def _same_outputs(got, want):
    for g, w in zip(got[0], want[0]):
        assert list(g.index) == list(w.index)
        assert list(g.columns) == list(w.columns)
        probs = [c for c in w.columns if c.startswith("prob_")]
        pd.testing.assert_frame_equal(g.drop(columns=probs),
                                      w.drop(columns=probs))
        np.testing.assert_allclose(g[probs].to_numpy(), w[probs].to_numpy(),
                                   atol=1e-3)
    for g, w in zip(got[1], want[1]):
        assert set(g) == set(w)
        rl_g, rl_w = g["reps_and_labels"], w["reps_and_labels"]
        assert rl_g["videonames"] == rl_w["videonames"]
        for key in ("reps", "probs"):
            assert sorted(rl_g[key]) == sorted(rl_w[key])
            for t in rl_w[key]:
                np.testing.assert_allclose(np.stack(rl_g[key][t]),
                                           np.stack(rl_w[key][t]), atol=1e-4)
        for name in ("attention", "importance"):
            if name in w:
                assert len(g[name]) == len(w[name])
                for a, b in zip(g[name], w[name]):
                    assert a.shape == b.shape
                    np.testing.assert_allclose(a, b, atol=1e-4)


def _both_assess(root, args, video, phase, nfolds=1):
    jax_main(["assess", "-f", video, "-p", str(root), "--phase", phase,
              *args])
    want = _outputs(root, video, phase, nfolds)
    cli.main(["assess", "-f", video, "-p", str(root), "--phase", phase,
              "--device", "cpu", *args])
    return _outputs(root, video, phase, nfolds), want


CLI_ASSESS_CASES = {
    "usc-table": (["-d", "NH_02"], "vid6", "USC_inference", "stitch"),
    "usc-table-flow": (["-d", "ND_02", "-mod", "RGB-Flow"], "vid8",
                       "USC_inference", "stitch"),
    "lab-table-flow": (["-d", "NW_02", "-mod", "RGB-Flow"], "vid8",
                       "Lab_inference", "stitch"),
    "stitch-rows": (["-d", "NW_02", "--flash", "on"], "vid5", "inference",
                    "stitch"),
    "segment-rows": ([], "vid9", "inference", "frames"),
}


@pytest.mark.parametrize("case", sorted(CLI_ASSESS_CASES))
def test_cli_assess_matches_jax(root, patched, capsys, case):
    """`assess --params-dir` over one fold: the EASE phase table (maj
    remapped, 5 high rows a video, balanced) or every row of the video,
    StartFrame / EndFrame derived for stitch rows; the skill CSV with the
    segments table's row labels as its index, and the artifacts."""
    args, video, phase, table = CLI_ASSESS_CASES[case]
    segs = root / f"{table}.csv"
    if table == "frames":
        # StartFrame / EndFrame rows (no per-RACE frame columns)
        write_csv(segs, [
            dict(Video=f"vid{v}", RACE=r, StartFrame=a, EndFrame=a + n)
            for v in range(16) for r, a, n in (
                ("Needle Driving", 40, 200), ("Needle Handling", 300, 90),
                ("Needle Withdrawal", 500, 150))])
    args = [*args, "--segments", str(segs), "--params-dir",
            str(root / "folds")]
    got, want = _both_assess(root, args, video, phase)
    _same_outputs(got, want)
    out = capsys.readouterr().out
    assert out.count("fold 0: wrote") == 2
    csv = got[0][0]
    assert len(csv) and (csv.index != np.arange(len(csv))).any()
    assert {"StartFrame", "EndFrame", "prob_0", "prob_1"} <= set(csv.columns)


def test_cli_assess_refuses_and_defaults_to_the_card(root, patched):
    """No rows for the video exits as the JAX CLI does; without --device
    the command asks for the card, which this host lacks."""
    base = ["assess", "-p", str(root), "--segments", str(root / "stitch.csv"),
            "--params-dir", str(root / "folds")]
    with pytest.raises(SystemExit, match="no segments for video nope"):
        cli.main([*base, "-f", "nope", "--device", "cpu"])
    with pytest.raises(RuntimeError, match="CUDA device"):
        cli.main([*base, "-f", "vid6"])


# ---------------------------------------------------------------------------
# The CLI: train --dataset vua-ease / vua-ease-stitch
# ---------------------------------------------------------------------------

def _train_args(root, *extra):
    return ["train", "-p", str(root), "--segments", str(root / "stitch.csv"),
            "--dataset", "vua-ease", "-bc", "-e", "2", "-bs", "4",
            "-lr", "0.05", *extra]


def _params(d):
    with open(d / "params.pkl", "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("trainer", ["port", "jax"])
def test_cli_train_vua_ease_folds_cross_read(root, patched, capsys, trainer,
                                             tmp_path):
    """`train --dataset vua-ease -d NH_02 -il --explanations ...` by one
    package writes a fold with the importance head that the other's
    `assess` reads: both assess commands write the same CSV and artifacts
    from it."""
    expl = [str(root / "expl0.csv"), str(root / "expl1.csv")]
    args = _train_args(root, "-d", "NH_02", "-il", "--explanations", *expl)
    if trainer == "port":
        cli.main([*args, "--device", "cpu"])
    else:
        jax_main(args)
    assert "saved fold 0" in capsys.readouterr().out
    fold = tmp_path / "params" / "Fold_0"
    shutil.move(root / "params" / "Fold_0", fold)
    assert "importance" in _params(fold)
    got, want = _both_assess(root, ["--segments", str(root / "stitch.csv"),
                                    "--params-dir", str(tmp_path / "params"),
                                    "-d", "NH_02"], "vid10", "USC_inference")
    _same_outputs(got, want)
    assert "importance" in got[1][0]


def test_cli_train_stitch_domains_and_multitask(root, patched, capsys,
                                                monkeypatch):
    """`--dataset vua-ease-stitch -tf 0.5` (3 sub-phase prototypes),
    `--domains NH_02 ND_02` (params/<domain>/Fold_0), `-d NH_02+ND_02`
    (linearB, 4 prototypes) and `-mod RGB-Flow` on videos of the fps table
    (collate_skill reads the flow rows; an untabled video raises KeyError
    in both packages, as in the reference); JAX's assess reads the
    stitch fold."""
    cpu = ["--device", "cpu"]
    cli.main([*_train_args(root, "--dataset", "vua-ease-stitch", "-tf",
                           "0.5"), *cpu])
    stitch = root / "params" / "Fold_0"
    with open(stitch / "prototypes.pkl", "rb") as f:
        assert np.asarray(pickle.load(f)).shape == (3, 256)
    jax_main(["assess", "-f", "vid6", "-p", str(root), "--segments",
              str(root / "stitch.csv"), "--params-dir", str(root / "params"),
              "--phase", "inference", "--nclasses", "3"])
    cli.main([*_train_args(root, "--domains", "NH_02", "ND_02"), *cpu])
    for dom in ("NH_02", "ND_02"):
        assert (root / "params" / dom / "Fold_0" / "params.pkl").exists()
    cli.main([*_train_args(root, "-d", "NH_02+ND_02"), *cpu])
    params = _params(root / "params" / "Fold_0")
    assert "linearB" in params and "importance" not in params
    with open(root / "params" / "Fold_0" / "prototypes.pkl", "rb") as f:
        assert np.asarray(pickle.load(f)).shape == (4, 256)
    flow = _train_args(root, "-d", "ND_02", "-mod", "RGB-Flow", "-e", "1")
    for run in (jax_main, lambda a: cli.main([*a, *cpu])):
        with pytest.raises(KeyError, match="fps table"):
            run(flow)
    for table in (jconfig.VUA_FPS_TABLE, tconfig.VUA_FPS_TABLE):
        for v in VIDEOS:
            monkeypatch.setitem(table, v, 30.0)
    cli.main([*flow, *cpu])
    out = capsys.readouterr().out
    assert out.count("saved fold 0") == 5 and "Domain: ND_02" in out


EXIT_CASES = {
    "bg-and-sg": ["-bg", "-sg", "x", "--meta", "m.csv"],
    "bg-without-bc": ["-bg", "--meta", "m.csv", "--no-bc"],
    "bg-without-meta": ["-bg"],
    "il-not-ease": ["--dataset", "vua-ease-stitch", "-il"],
    "il-without-explanations": ["-il"],
    "tf-not-stitch": ["-tf", "0.5"],
}


@pytest.mark.parametrize("case", sorted(EXIT_CASES))
def test_cli_train_exits_like_jax(root, patched, case):
    """Bad flag combinations of the EASE branches exit with the JAX CLI's
    messages."""
    flags = list(EXIT_CASES[case])
    args = _train_args(root, *flags)
    if "--no-bc" in flags:
        args = [a for a in args if a not in ("-bc", "--no-bc")]
    msgs = []
    for run in (jax_main, lambda a: cli.main([*a, "--device", "cpu"])):
        with pytest.raises(SystemExit) as info:
            run(args)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1] and msgs[0]
