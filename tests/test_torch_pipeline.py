"""The port's RGB slice end to end against the JAX package on the CPU:
feature extraction, windowed TTA + fold decoding, the gestures CSV, the
CLI, the device default and the package's import isolation."""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from sais_tpu import config as jconfig
from sais_tpu.infer.pipeline import FeatureExtractor as JaxExtractor
from sais_tpu.infer.pipeline import GestureDecoder as JaxDecoder
from sais_tpu.infer.postprocess import \
    decode_gesture_intervals as jax_intervals
from sais_tpu.models.full_model import full_model_init as jax_model_init
from sais_tpu.models.full_model import prototypes_init as jax_protos_init
from sais_tpu.models.vit import vit_init as jax_vit_init
from sais_tpu_torch import config as tconfig
from sais_tpu_torch.infer.pipeline import FeatureExtractor, GestureDecoder
from sais_tpu_torch.infer.postprocess import (decode_gesture_intervals,
                                              write_rows_csv)
from sais_tpu_torch.models.full_model import FullModel
from sais_tpu_torch.models.vit import VisionTransformer
from sais_tpu_torch.port.weights import (full_model_params_from_jax,
                                         vit_params_from_jax)

DIM = 64


def tiny_cfg(cfgmod, dtype="float32"):
    return cfgmod.PipelineConfig(
        vit=cfgmod.ViTConfig(image_size=32, patch_size=8, embed_dim=DIM,
                             depth=2, num_heads=4),
        preprocess=cfgmod.PreprocessConfig(resize=32),
        model=cfgmod.ModelConfig(
            rep_dim=DIM, modalities="RGB",
            temporal=cfgmod.TemporalConfig(rep_dim=DIM, num_layers=2,
                                           num_heads=4, ffn_dim=128)),
        compute_dtype=dtype)


def _frames(n=120, h=48, w=64, seed=0):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    for i in range(n):           # a slow sweep, so windows differ
        frames[i, :, : i * w // n] = (255, 0, 0)
    return frames


def _folds(n):
    jcfg, tcfg = tiny_cfg(jconfig), tiny_cfg(tconfig)
    jfolds, tfolds = [], []
    for k in range(n):
        params = jax_model_init(jax.random.key(10 + k), jcfg.model)
        _, protos = jax_protos_init(jax.random.key(20 + k), 2)
        model = FullModel(tcfg.model)
        model.load_state_dict(full_model_params_from_jax(params))
        jfolds.append((params, protos))
        tfolds.append((model, torch.tensor(np.asarray(protos))))
    return jfolds, tfolds


def test_extract_array_matches_jax():
    jcfg, tcfg = tiny_cfg(jconfig), tiny_cfg(tconfig)
    vparams = jax_vit_init(jax.random.key(0), jcfg.vit)
    model = VisionTransformer(tcfg.vit)
    model.load_state_dict(vit_params_from_jax(vparams))
    frames = _frames(n=40)
    ref = JaxExtractor(vparams, jcfg, batch_size=16,
                       use_native_decode=False).extract_array(frames)
    got = FeatureExtractor(model, tcfg, batch_size=16,
                           device="cpu").extract_array(frames)
    assert got.shape == ref.shape == (40, DIM)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("nfolds", [1, 2])
def test_window_probs_and_rows_match_jax(nfolds):
    jcfg, tcfg = tiny_cfg(jconfig), tiny_cfg(tconfig)
    reps = np.random.default_rng(nfolds).standard_normal(
        (120, DIM)).astype(np.float32)
    jfolds, tfolds = _folds(nfolds)
    jdec = JaxDecoder(jfolds, jcfg, device_batch=4)
    tdec = GestureDecoder(tfolds, tcfg, device_batch=4, device="cpu")
    ref = jdec.window_probs("vid", reps, None)
    got = tdec.window_probs("vid", reps)
    assert got.shape == ref.shape == (8, 2)   # (120 - 15) // 15 + 1 windows
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-6)
    df = jdec.decode("vid", reps, None)
    rows = tdec.decode("vid", reps)
    assert len(rows) == len(df)
    assert [list(r) for r in rows] == [list(df.columns)] * len(df)


def _csv_text_equal(rows, df, tmp_path):
    path = tmp_path / "port.csv"
    write_rows_csv(rows, str(path))
    buf = io.StringIO()
    df.to_csv(buf)
    assert path.read_text() == buf.getvalue()


@pytest.mark.parametrize("confident", [True, False])
def test_gesture_csv_equals_pandas(confident, tmp_path):
    """Crafted window probabilities that survive the entropy filter (or,
    unconfident, leave no interval): the port's rows and CSV text equal
    the JAX package's DataFrame and its to_csv."""
    rng = np.random.default_rng(7)
    p1 = np.where(rng.random(40) < 0.5, 0.97, 0.02) if confident \
        else np.full(40, 0.5)
    p1[10:14] = 0.99 if confident else 0.5
    probs = np.stack([1 - p1, p1], 1)
    starts = np.arange(40) * 15
    cfg = jconfig.PostprocessConfig()
    df = jax_intervals(probs, starts, starts + 15, "vidX", cfg)
    rows = decode_gesture_intervals(probs, starts, starts + 15, "vidX",
                                    tconfig.PostprocessConfig())
    assert (len(df) > 0) == confident and len(rows) == len(df)
    _csv_text_equal(rows, df, tmp_path)


def _synth_video(path, nframes=60, h=48, w=64):
    import cv2
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30,
                             (w, h))
    assert writer.isOpened()
    for f in _frames(nframes, h, w, seed=1):
        writer.write(f[:, :, ::-1])
    writer.release()


def test_cli_pipeline_rgb_on_cpu(tmp_path, monkeypatch, capsys):
    """`pipeline -mod RGB --device cpu --random-init` on a synthetic mp4,
    with a tiny architecture in place of ViT-S; bf16 by default, so the
    fused path runs (K1's plain version on the CPU).  Then `decode -mod
    RGB-Flow` without a flow store refuses to make up a flow stream."""
    from sais_tpu_torch.cli import main as cli

    root = tmp_path
    os.makedirs(root / "videos")
    _synth_video(str(root / "videos" / "vid.mp4"))
    monkeypatch.setattr(cli, "PipelineConfig",
                        lambda: tiny_cfg(tconfig, dtype="bfloat16"))
    cli.main(["pipeline", "-f", "vid", "-p", str(root), "-mod", "RGB",
              "--device", "cpu", "--random-init", "-bs", "16"])
    out = capsys.readouterr().out
    assert "extracted (60, 64)" in out and "gesture intervals" in out
    csv = root / "results" / "Custom_inference_gestures.csv"
    assert csv.exists()
    from sais_tpu_torch.io.feature_store import FeatureStore, rgb_store_path
    with FeatureStore(rgb_store_path(str(root))) as fs:
        reps = fs.read_video("vid")
    assert reps.shape == (60, DIM) and np.isfinite(reps).all()
    # with no flow store, -mod RGB-Flow raises what the JAX decoder raises
    # (sais_tpu/infer/pipeline.py:732)
    with pytest.raises(ValueError, match="flow store missing"):
        cli.main(["decode", "-f", "vid", "-p", str(root), "-mod",
                  "RGB-Flow", "--device", "cpu", "--random-init"])


def test_cli_decode_reads_reference_folds(tmp_path, monkeypatch, capsys):
    """`decode --params-dir` with reference folds (Fold_<i>/params.zip +
    prototypes.zip written by torch.save), and beside one a fold trained
    by the JAX package (params.pkl + prototypes.pkl from its
    save_training_result): the port reads it, and its window
    probabilities equal the JAX decoder's on that fold within 1e-3."""
    from sais_tpu_torch.cli import main as cli
    from sais_tpu_torch.io.feature_store import FeatureStore, rgb_store_path
    from tests.golden.torch_temporal import random_full_model_state_dict

    monkeypatch.setattr(cli, "PipelineConfig", lambda: tiny_cfg(tconfig))
    with FeatureStore(rgb_store_path(str(tmp_path)), "a") as fs:
        fs.write_video("vid", np.random.default_rng(0).standard_normal(
            (90, DIM)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    fold = tmp_path / "params" / "Fold_0"
    os.makedirs(fold)
    sd = random_full_model_state_dict(gen, dim=DIM, ffn=128, layers=2,
                                      pos_slots=2000)
    torch.save({f"module.{k}": v for k, v in sd.items()},
               fold / "params.zip")
    torch.save({"0": torch.rand(1, 256, generator=gen),
                "1": torch.rand(1, 256, generator=gen)},
               fold / "prototypes.zip")
    argv = ["decode", "-f", "vid", "-p", str(tmp_path), "--device", "cpu",
            "--params-dir", str(tmp_path / "params")]
    cli.main(argv)
    assert "gesture intervals" in capsys.readouterr().out
    assert (tmp_path / "results" / "Custom_inference_gestures.csv").exists()
    from sais_tpu.train.checkpoint import save_training_result
    jfold, _ = _folds(1)
    params, protos = jfold[0]
    save_training_result(str(tmp_path / "params" / "Fold_1"),
                         {"model": params, "prototypes": protos,
                          "metrics": {"loss": [0.5]}})
    cli.main(argv + ["--nfolds", "2"])
    assert "gesture intervals" in capsys.readouterr().out
    model, got_protos = cli.load_fold(str(tmp_path / "params" / "Fold_1"),
                                      tiny_cfg(tconfig))
    reps = np.random.default_rng(0).standard_normal((90, DIM)).astype(
        np.float32)
    ref = JaxDecoder(jfold, tiny_cfg(jconfig)).window_probs("vid", reps,
                                                            None)
    got = GestureDecoder([(model, got_protos)], tiny_cfg(tconfig),
                         device="cpu").window_probs("vid", reps)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)


def test_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks a host without CUDA")
    cfg = tiny_cfg(tconfig)
    with pytest.raises(RuntimeError, match="CUDA"):
        FeatureExtractor(VisionTransformer(cfg.vit), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        GestureDecoder([(FullModel(cfg.model), torch.ones(2, 256))], cfg)
    from sais_tpu_torch.cli import main as cli
    os.makedirs(tmp_path / "videos")
    _synth_video(str(tmp_path / "videos" / "v.mp4"), nframes=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["extract", "-f", "v", "-p", str(tmp_path),
                  "--random-init"])


def test_port_imports_no_jax_and_nothing_of_sais_tpu():
    """Every module of the port, imported in a fresh interpreter (among them
    the serve daemon, the eval modules, port.verify, utils.profiling and
    the parallel package: mesh, distributed, sequence and tp),
    leaves jax, the JAX package and its optimizer and checkpoint libraries
    (optax, orbax), the host libraries the port loads lazily (cv2, h5py,
    PIL) and the ones it does without (pandas, sklearn) out of
    sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import sais_tpu_torch\n"
        "for m in pkgutil.walk_packages(sais_tpu_torch.__path__,"
        " 'sais_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'sais_tpu', 'optax', 'orbax', 'cv2', 'h5py',"
        " 'PIL', 'pandas', 'sklearn'))\n"
        "need = ['sais_tpu_torch.cli.serve', 'sais_tpu_torch.port.verify',"
        " 'sais_tpu_torch.utils.profiling'] + ['sais_tpu_torch.eval.' + m"
        " for m in ('attention_viz', 'video_generation', 'probes',"
        " 'retrieval', 'copy_detection', 'video_segmentation')]"
        " + ['sais_tpu_torch.parallel.' + m for m in ('mesh',"
        " 'distributed', 'sequence', 'tp')]\n"
        "bad += [m + ' not imported' for m in need if m not in sys.modules]\n"
        "print(len([m for m in sys.modules"
        " if m.startswith('sais_tpu_torch.')]), bad)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    count, bad = res.stdout.split(" ", 1)
    assert int(count) >= 35 and bad.strip() == "[]", res.stdout


@pytest.mark.parametrize("arch", ["vits8", "vitb8", "dino_vits8"])
def test_cli_pretrain_takes_patch8_archs_on_the_card(arch, tmp_path,
                                                    monkeypatch):
    """`pretrain --arch <patch-8 arch>` with the card as its device reaches
    DINOTrainer with the zoo's patch-8 geometry (785 tokens a 224 px global
    crop): nothing on the way refuses it.  The device resolves to "cuda"
    without a card here, and the trainer is replaced by a recorder that
    stops the command."""
    import sais_tpu_torch
    from sais_tpu_torch.cli import main as cli
    from sais_tpu_torch.models import zoo
    from sais_tpu_torch.train import dino

    class Reached(Exception):
        pass

    seen = []

    def trainer(vit_cfg, dcfg, niter_per_ep, generator, optimizer, device,
                mesh=None):
        seen.append((vit_cfg, dcfg, device))
        raise Reached

    monkeypatch.setattr(dino, "DINOTrainer", trainer)
    monkeypatch.setattr(sais_tpu_torch, "resolve_device",
                        lambda device=None: torch.device(device or "cuda"))
    os.makedirs(tmp_path / "videos")
    _synth_video(str(tmp_path / "videos" / "v.mp4"), nframes=8)
    with pytest.raises(Reached):
        cli.main(["pretrain", "-p", str(tmp_path), "--arch", arch])
    (vit_cfg, dcfg, device), = seen
    assert device.type == "cuda" and vit_cfg == zoo.config(arch)
    assert vit_cfg.patch_size == 8
    assert (dcfg.global_size // vit_cfg.patch_size) ** 2 + 1 == 785
