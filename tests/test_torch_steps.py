"""The port's step-recognition slice against the JAX package on the CPU:
step windows, `StepRecognizer` on the dense and the
flash (K2) path, `GestureDecoder.inference_artifacts`, the artifact
pickles, positional tables longer than 2000 slots, and the `steps` and
`decode --save-artifacts` commands of the port's CLI.  The JAX side runs
its flash kernel in interpret mode, as tests/test_skill_and_steps.py and
tests/test_flash_wiring.py run it."""

import dataclasses
import io
import os
import pickle

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from sais_tpu import config as jconfig
from sais_tpu.data import tasks as jtasks
from sais_tpu.infer.pipeline import GestureDecoder as JaxDecoder
from sais_tpu.infer.skill import StepRecognizer as JaxRecognizer
from sais_tpu.models import full_model as jfm
from sais_tpu.train.checkpoint import \
    save_inference_artifacts as jax_save_artifacts
from sais_tpu_torch import config as tconfig
from sais_tpu_torch.data import tasks
from sais_tpu_torch.infer.pipeline import GestureDecoder
from sais_tpu_torch.infer.postprocess import write_rows_csv
from sais_tpu_torch.infer.skill import StepRecognizer
from sais_tpu_torch.models.full_model import FullModel, temporal_features
from sais_tpu_torch.port.weights import (full_model_params_from_jax,
                                         full_model_params_from_reference)
from sais_tpu_torch.train.checkpoint import save_inference_artifacts

DIM = 64
FPS = 6.0          # 10 s windows of 60 frames, 5 s hop
NFRAMES = 300      # (300 - 60) // 30 + 1 = 9 step windows
CLASSES = ["Needle Handling", "Needle Driving", "Needle Withdrawal"]


def step_cfg(cfgmod, use_flash, stride_divisor=4096):
    """Tiny temporal model (D 64, 2 layers, 4 heads) on the step geometry;
    stride_divisor 4096 gives stride 1: windows of 61 / 58 / 55 tokens
    over the 3 TTA offsets."""
    taskmod = jtasks if cfgmod is jconfig else tasks
    window = dataclasses.replace(taskmod.step_window_config(FPS),
                                 stride_divisor=stride_divisor)
    return cfgmod.PipelineConfig(
        model=cfgmod.ModelConfig(
            rep_dim=DIM, modalities="RGB", nclasses=3,
            temporal=cfgmod.TemporalConfig(rep_dim=DIM, num_layers=2,
                                           num_heads=4, ffn_dim=128,
                                           use_flash=use_flash)),
        window=window, compute_dtype="float32")


def _fold(seed, cfg):
    params = jfm.full_model_init(jax.random.key(seed), cfg.model)
    _, protos = jfm.prototypes_init(jax.random.key(seed + 1), 3)
    model = FullModel(step_cfg(tconfig, None).model)
    model.load_state_dict(full_model_params_from_jax(params))
    return (params, protos), (model, torch.tensor(np.asarray(protos)))


def _reps(seed, n=NFRAMES):
    return np.random.default_rng(seed).standard_normal(
        (n, DIM)).astype(np.float32)


def _decoders(use_flash, seed=0):
    jcfg, tcfg = step_cfg(jconfig, use_flash), step_cfg(tconfig, use_flash)
    jfold, tfold = _fold(seed, jcfg)
    return (JaxDecoder([jfold], jcfg, device_batch=4),
            GestureDecoder([tfold], tcfg, device_batch=4, device="cpu"))


def test_step_windows_match_jax():
    for total, fps in ((1000, 20.0), (20000, 30.0), (150, 30.0), (0, 20.0)):
        a = tasks.step_window_manifest("v", total, fps)
        b = jtasks.step_window_manifest("v", total, fps)
        np.testing.assert_array_equal(a.start_frames, b.start_frames)
        np.testing.assert_array_equal(a.end_frames, b.end_frames)
    # every field of the port's WindowConfig (the JAX one also carries a
    # flag nothing reads, preserve_negative_index)
    for fps in (20.0, 30.0, 25.0):
        port_cfg = dataclasses.asdict(tasks.step_window_config(fps))
        jax_cfg = jtasks.step_window_config(fps)
        assert port_cfg == {k: getattr(jax_cfg, k) for k in port_cfg}


@pytest.mark.parametrize("use_flash", [False, True])
def test_step_recognizer_matches_jax(use_flash, tmp_path):
    """Full-length windows (stride 1) over 9 step windows: the same
    windows and steps as the JAX package, probabilities within 1e-3 (the
    window tolerance of the gesture slice), and a CSV in the layout of the
    JAX package's `df.to_csv`."""
    jdec, tdec = _decoders(use_flash)
    rgb = _reps(1)
    df = JaxRecognizer(jdec, fps=FPS).recognize("case1", rgb, None)
    rec = StepRecognizer(tdec, fps=FPS)
    rows = rec.recognize("case1", rgb)
    assert len(rows) == len(df) == 9
    assert rec.columns == list(df.columns)
    for col in ("Video", "StartFrame", "EndFrame", "Step"):
        assert [r[col] for r in rows] == df[col].tolist(), col
    probs = np.array([[r[c] for c in CLASSES] for r in rows])
    np.testing.assert_allclose(probs, df[CLASSES].to_numpy(), rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(probs.sum(1), 1.0, atol=1e-6)
    # the JAX package's frame, carrying the port's values, writes the
    # same text as the port
    df[CLASSES] = probs
    write_rows_csv(rows, str(tmp_path / "steps.csv"), rec.columns)
    buf = io.StringIO()
    df.to_csv(buf)
    assert (tmp_path / "steps.csv").read_text() == buf.getvalue()


def test_step_recognizer_short_video_writes_header_only(tmp_path):
    """A video shorter than one 10 s window: no rows, and the CSV holds
    the header alone, as the JAX package's empty frame writes it."""
    jdec, tdec = _decoders(False)
    rgb = _reps(2, n=40)
    df = JaxRecognizer(jdec, fps=FPS).recognize("short", rgb, None)
    rec = StepRecognizer(tdec, fps=FPS)
    rows = rec.recognize("short", rgb)
    assert rows == [] and len(df) == 0
    write_rows_csv(rows, str(tmp_path / "s.csv"), rec.columns)
    buf = io.StringIO()
    df.to_csv(buf)
    assert (tmp_path / "s.csv").read_text() == buf.getvalue()
    with pytest.raises(ValueError, match="fps"):
        StepRecognizer(tdec, fps=20.0).recognize("short", rgb)


@pytest.mark.parametrize("use_flash", [False, True])
def test_inference_artifacts_match_jax(use_flash):
    """Per-TTA reps and probabilities and the first augment's attention:
    the dense (W, L, L) matrices, or the (W, L) CLS rows on the flash
    path.  Limit 1e-4, the temporal model's limit against JAX."""
    jdec, tdec = _decoders(use_flash, seed=3)
    rgb = _reps(4)
    ref = jdec.inference_artifacts("case2", rgb, None)
    got = tdec.inference_artifacts("case2", rgb)
    assert sorted(got["reps"]) == sorted(ref["reps"]) == [0, 1, 2]
    for key in ("reps", "probs"):
        for ti in ref[key]:
            assert got[key][ti].dtype == np.float32
            np.testing.assert_allclose(got[key][ti], ref[key][ti], atol=1e-4)
    shape = (9, 61) if use_flash else (9, 61, 61)
    assert got["attention"].shape == ref["attention"].shape == shape
    np.testing.assert_allclose(got["attention"], ref["attention"], atol=1e-4)
    for key in ("start_frames", "end_frames"):
        np.testing.assert_array_equal(got[key], ref[key])
    assert got["videonames"] == ref["videonames"] == ["case2"] * 9


def _assert_same_tree(a, b):
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _assert_same_tree(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same_tree(x, y)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_save_inference_artifacts_matches_jax(tmp_path):
    """The same payload through both packages' writers: the same files,
    holding the same numpy trees."""
    rng = np.random.default_rng(5)
    reps = {ti: rng.standard_normal((4, 256)).astype(np.float32)
            for ti in range(3)}
    probs = {ti: rng.random((4, 3)).astype(np.float32) for ti in range(3)}
    attention = rng.random((4, 9)).astype(np.float32)
    payload = {"reps": reps, "probs": probs, "videonames": ["v"] * 4}
    jax_save_artifacts(str(tmp_path / "jax"), "Custom_inference", payload,
                       attention=attention)
    save_inference_artifacts(
        str(tmp_path / "port"), "Custom_inference",
        {"reps": {k: torch.tensor(v) for k, v in reps.items()},
         "probs": probs, "videonames": ["v"] * 4},
        attention=torch.tensor(attention))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == [
        "attention_Custom_inference.pkl",
        "reps_and_labels_Custom_inference.pkl"]
    for name in names:
        with open(tmp_path / "jax" / name, "rb") as f:
            want = pickle.load(f)
        with open(tmp_path / "port" / name, "rb") as f:
            got = pickle.load(f)
        _assert_same_tree(got, want)


def test_pos_table_of_any_length():
    """A 2600-slot positional table (--max-positions 2600) carried from
    JAX params and from a reference checkpoint; a 2100-frame window agrees
    with the JAX package (dense, 1e-4), and the reference's 2000-slot
    table refuses it instead of cutting frames."""
    from tests.golden.torch_temporal import random_full_model_state_dict

    temporal = dict(rep_dim=32, num_layers=1, num_heads=4, ffn_dim=64,
                    use_flash=False)
    jcfg = jconfig.ModelConfig(rep_dim=32, modalities="RGB",
                               temporal=jconfig.TemporalConfig(
                                   **temporal, max_positions=2600))
    cfg = tconfig.ModelConfig(rep_dim=32, modalities="RGB",
                              temporal=tconfig.TemporalConfig(
                                  **temporal, max_positions=2600))
    params = jfm.full_model_init(jax.random.key(6), jcfg)
    model = FullModel(cfg)
    model.load_state_dict(full_model_params_from_jax(params))
    sd = random_full_model_state_dict(torch.Generator().manual_seed(0),
                                      dim=32, ffn=64, layers=1,
                                      pos_slots=2600)
    assert full_model_params_from_reference(sd)["frame_pos"].shape == (
        2600, 32)
    reps = np.random.default_rng(7).standard_normal(
        (1, 1, 2100, 32)).astype(np.float32)
    ref = jfm.temporal_features(params, jnp.asarray(reps), None, jcfg)
    with torch.no_grad():
        got = temporal_features(model, torch.tensor(reps), None, cfg)
    np.testing.assert_allclose(got.cls_seq.numpy(), np.asarray(ref.cls_seq),
                               atol=1e-4)
    small = FullModel(dataclasses.replace(cfg, temporal=dataclasses.replace(
        cfg.temporal, max_positions=2000)))
    with pytest.raises(ValueError, match="max-positions"):
        temporal_features(small, torch.tensor(reps), None, cfg)


def _cli_root(tmp_path, monkeypatch, nframes):
    from sais_tpu_torch.cli import main as cli
    from sais_tpu_torch.io.feature_store import FeatureStore, rgb_store_path

    def tiny():
        cfg = step_cfg(tconfig, None)
        return dataclasses.replace(cfg, window=tconfig.WindowConfig())

    monkeypatch.setattr(cli, "PipelineConfig", tiny)
    with FeatureStore(rgb_store_path(str(tmp_path)), "a") as fs:
        fs.write_video("vid", _reps(8, n=nframes))
    return cli


def test_cli_steps(tmp_path, monkeypatch, capsys):
    """`steps --stride-divisor 4096 --flash on --device cpu --random-init`
    (K2's plain version on the CPU) writes results/vid_steps.csv in the
    steps layout; `--seq-parallel` is refused until the ring is ported."""
    cli = _cli_root(tmp_path, monkeypatch, NFRAMES)
    argv = ["steps", "-f", "vid", "-p", str(tmp_path), "-mod", "RGB",
            "--random-init", "--device", "cpu", "--fps", str(FPS),
            "--stride-divisor", "4096", "--flash", "on"]
    cli.main(argv)
    assert "wrote 9 step windows" in capsys.readouterr().out
    df = pd.read_csv(tmp_path / "results" / "vid_steps.csv", index_col=0)
    assert list(df.columns) == ["Video", "StartFrame", "EndFrame", "Step",
                                *CLASSES]
    assert df["StartFrame"].tolist() == list(range(0, 270, 30))
    np.testing.assert_allclose(df[CLASSES].sum(axis=1), 1.0, atol=1e-6)
    with pytest.raises(NotImplementedError, match="seq-parallel"):
        cli.main(argv + ["--seq-parallel", "2"])
    if not torch.cuda.is_available():   # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main([a for a in argv if a not in ("--device", "cpu")])


@pytest.mark.parametrize("cmd", ["extract", "decode", "pipeline", "steps",
                                 "train"])
def test_cli_refuses_data_parallel(cmd, tmp_path):
    """`--data-parallel` is refused, not ignored, by every command that runs
    on one card, before any file is read: the root does not exist."""
    from sais_tpu_torch.cli import main as cli
    root = tmp_path / "absent"
    argv = [cmd, "-p", str(root), "--random-init", "--device", "cpu",
            "--data-parallel", "2"]
    argv += (["--segments", str(root / "segs.csv")] if cmd == "train"
             else ["-f", "vid"])
    with pytest.raises(NotImplementedError, match="data-parallel"):
        cli.main(argv)
    assert not root.exists()


@pytest.mark.parametrize("flash", ["auto", "on"])
def test_cli_decode_save_artifacts(flash, tmp_path, monkeypatch, capsys):
    """`decode --save-artifacts` writes reps_and_labels and attention
    pickles under params/Fold_0: (W, L, L) matrices on the dense path
    (auto on the CPU), (W, L) CLS rows with --flash on."""
    cli = _cli_root(tmp_path, monkeypatch, 90)
    cli.main(["decode", "-f", "vid", "-p", str(tmp_path), "-mod", "RGB",
              "--random-init", "--device", "cpu", "--flash", flash,
              "--save-artifacts"])
    assert "inference artifacts" in capsys.readouterr().out
    fold = tmp_path / "params" / "Fold_0"
    with open(fold / "reps_and_labels_Custom_inference.pkl", "rb") as f:
        art = pickle.load(f)
    with open(fold / "attention_Custom_inference.pkl", "rb") as f:
        attention = pickle.load(f)
    nwin = (90 - 15) // 15 + 1
    assert sorted(art) == ["probs", "reps", "videonames"]
    assert art["reps"][0].shape == (nwin, 256)
    assert art["probs"][2].shape == (nwin, 2)
    assert len(art["videonames"]) == nwin
    # 15-frame windows at stride 1 (span // 10): 15 frames + CLS
    assert attention.shape == ((nwin, 16) if flash == "on"
                               else (nwin, 16, 16))


def test_cli_flags_reach_the_config(tmp_path, monkeypatch):
    """--flash and --max-positions reach TemporalConfig; a reference fold
    keeps its own table length whatever --max-positions says."""
    from sais_tpu_torch.cli import main as cli
    from tests.golden.torch_temporal import random_full_model_state_dict

    p = cli.build_parser()
    args = p.parse_args(["steps", "-f", "v", "--max-positions", "4096",
                         "--flash", "off"])
    t = cli._pipeline_config(args).model.temporal
    assert (t.max_positions, t.use_flash) == (4096, False)
    t = cli._pipeline_config(p.parse_args(["steps", "-f", "v"])).model.temporal
    assert (t.max_positions, t.use_flash) == (2000, None)
    fold = tmp_path / "Fold_0"
    os.makedirs(fold)
    gen = torch.Generator().manual_seed(1)
    torch.save(random_full_model_state_dict(gen, dim=384, ffn=2048,
                                            layers=4, pos_slots=2600),
               fold / "params.zip")
    torch.save({str(i): torch.rand(1, 256, generator=gen) for i in range(3)},
               fold / "prototypes.zip")
    args = p.parse_args(["steps", "-f", "v", "--params-dir", str(tmp_path)])
    (model, protos), = cli._load_folds(args, cli._pipeline_config(args))
    assert model.frame_pos.shape == (2600, 384) and protos.shape == (3, 256)
