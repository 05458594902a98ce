"""The port's evaluation modules and the ViT's attention and token outputs
against the JAX package on the CPU, from the same weights and numpy-seeded
inputs: `models/vit` (last-block attention, tokens, intermediate layers),
`eval/attention_viz` and `video_generation` with the `attention` CLI,
`eval/probes` with the `eval` CLI, `models/zoo.create`, `utils/profiling`,
and the library-only `eval/retrieval`, `copy_detection` and
`video_segmentation`.  Limits: 1e-4 for float32 model outputs, bitwise for
the numpy post-processing, equal accuracies and mAPs."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sais_tpu import config as jconfig
from sais_tpu.port.torch_port import vit_params_from_torch
from sais_tpu_torch import config as tconfig
from sais_tpu_torch.models.vit import VisionTransformer
from tests.golden.torch_vit import random_dino_state_dict

TINY = dict(image_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4)


def _vit(seed=0):
    """(JAX params, port float32 model, JAX ViTConfig), the same weights."""
    sd = random_dino_state_dict(torch.Generator().manual_seed(seed), depth=2,
                                dim=64, heads=4, patch=8, img=32)
    model = VisionTransformer(tconfig.ViTConfig(**TINY))
    model.load_state_dict(sd)
    return vit_params_from_torch(sd), model.eval(), jconfig.ViTConfig(**TINY)


def _images(n=3, size=32, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, size, size, 3)).astype(np.float32)


def _close(got, want, tol=1e-4):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1.0), err


# ---------------------------------------------------------------- ViT --

def test_vit_last_attention_tokens_and_layers_match_jax():
    from sais_tpu.models import vit as jvit
    from sais_tpu_torch.models import vit as tvit
    params, model, cfg = _vit()
    x = _images()
    jcls, jattn = jvit.vit_forward(params, jnp.asarray(x), cfg,
                                   return_last_attention=True)
    with torch.no_grad():
        cls, attn = tvit.vit_forward(model, torch.from_numpy(x),
                                     return_last_attention=True)
        assert torch.equal(cls, tvit.vit_forward(model, torch.from_numpy(x)))
        toks = tvit.vit_tokens(model, torch.from_numpy(x))
        layers = tvit.vit_intermediate_layers(model, torch.from_numpy(x), n=2)
    assert attn.shape == (3, 4, 17, 17)
    _close(cls, jcls)
    _close(attn, jattn)
    _close(toks, jvit.vit_tokens(params, jnp.asarray(x), cfg))
    jlayers = jvit.vit_intermediate_layers(params, jnp.asarray(x), cfg, n=2)
    assert len(layers) == len(jlayers) == 2
    for a, b in zip(layers, jlayers):
        _close(a, b)
    _close(toks[:, 0], cls)


# ---------------------------------------------------------- attention --

def test_attention_maps_masks_and_upsampling_match_jax():
    from sais_tpu.eval import attention_viz as jav
    from sais_tpu_torch.eval import attention_viz as tav
    params, model, cfg = _vit()
    x = _images()
    maps = tav.cls_attention_maps(model, torch.from_numpy(x))
    jmaps = jav.cls_attention_maps(params, jnp.asarray(x), cfg)
    assert maps.shape == (3, 4, 4, 4) and maps.dtype == np.float32
    _close(maps, jmaps)
    for th in (0.3, 0.6, 0.9):
        assert np.array_equal(tav.threshold_masks(jmaps, th),
                              jav.threshold_masks(jmaps, th))
    assert np.array_equal(tav.upsample_maps(jmaps, 8),
                          jav.upsample_maps(jmaps, 8))


def _tiny_pipeline(cfgmod):
    return cfgmod.PipelineConfig(
        vit=cfgmod.ViTConfig(**TINY),
        preprocess=cfgmod.PreprocessConfig(resize=32))


def _both_clis(monkeypatch, tmp_path, weights, *argv):
    """Run `attention` through the JAX CLI and the port's, each in its own
    root (with the same inputs), the pipeline config patched tiny in both;
    returns the two roots."""
    from sais_tpu.cli import main as jcli
    from sais_tpu_torch.cli import main as tcli
    jcfg, tcfg = _tiny_pipeline(jconfig), _tiny_pipeline(tconfig)
    monkeypatch.setattr(jconfig, "PipelineConfig", lambda: jcfg)
    monkeypatch.setattr(tcli, "PipelineConfig", lambda: tcfg)
    roots = []
    for name, cli, extra in (("jax", jcli, []),
                             ("port", tcli, ["--device", "cpu"])):
        root = tmp_path / name
        os.makedirs(root / "videos", exist_ok=True)
        if (tmp_path / "v.mp4").exists():
            os.link(tmp_path / "v.mp4", root / "videos" / "v.mp4")
        cli.main(["attention", "-p", str(root), "--dino-weights", weights,
                  *argv, *extra])
        roots.append(root)
    return roots


def _weights_file(tmp_path, name):
    path = str(tmp_path / name)
    torch.save(random_dino_state_dict(torch.Generator().manual_seed(0),
                                      depth=2, dim=64, heads=4, patch=8,
                                      img=32), path)
    return path


def test_cli_attention_image_matches_jax(tmp_path, monkeypatch):
    """`attention --image x.png --attn-threshold 0.6`: the same files, the
    heatmaps within one level (min-max scaled to 0..255 from maps within
    1e-6) and the masks equal."""
    from PIL import Image
    img = (np.random.default_rng(1).random((48, 64, 3)) * 255).astype(
        np.uint8)
    Image.fromarray(img).save(tmp_path / "x.png")
    jroot, troot = _both_clis(
        monkeypatch, tmp_path, _weights_file(tmp_path, "img_vit.pth"),
        "--image", str(tmp_path / "x.png"), "--attn-threshold", "0.6")
    names = sorted(os.listdir(jroot / "results"))
    assert names == sorted(os.listdir(troot / "results"))
    assert len(names) == 8          # 4 heads, heatmap and mask each
    for name in names:
        a = np.asarray(Image.open(jroot / "results" / name), np.int16)
        b = np.asarray(Image.open(troot / "results" / name), np.int16)
        assert a.shape == b.shape == (32, 32)
        if "_mask_" in name:
            assert np.array_equal(a, b), name
        else:
            assert np.abs(a - b).max() <= 1, name


def test_cli_attention_video_matches_jax(tmp_path, monkeypatch):
    """`attention -f v`: an overlay mp4 of every frame, at the size the ViT
    saw, that decodes to the JAX CLI's frames (within a level on average:
    both encode with OpenCV's mp4v)."""
    import cv2
    from tests.test_torch_pipeline import _synth_video
    _synth_video(str(tmp_path / "v.mp4"), nframes=12)
    jroot, troot = _both_clis(
        monkeypatch, tmp_path, _weights_file(tmp_path, "vid_vit.pth"),
        "-f", "v", "-bs", "5")
    frames = []
    for root in (jroot, troot):
        cap = cv2.VideoCapture(str(root / "results" / "v_attention.mp4"))
        out = []
        while True:
            ok, f = cap.read()
            if not ok:
                break
            out.append(f.astype(np.int16))
        cap.release()
        frames.append(np.stack(out))
    assert frames[0].shape == frames[1].shape == (12, 32, 32, 3)
    assert np.abs(frames[0] - frames[1]).mean() < 1.0


# -------------------------------------------------------------- probes --

def _clusters(n, d=32, classes=5, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((classes, d)).astype(np.float32)
    y = rng.integers(0, classes, n)
    x = centers[y] + 0.8 * rng.standard_normal((n, d)).astype(np.float32)
    return x.astype(np.float32), y


def test_knn_classifier_matches_jax():
    from sais_tpu.eval.probes import knn_classifier as jknn
    from sais_tpu_torch.eval.probes import knn_classifier
    xtr, ytr = _clusters(700)
    xte, yte = _clusters(300, seed=1)
    got = knn_classifier(xtr, ytr, xte, yte, k=20, chunk=128, device="cpu")
    want = jknn(xtr, ytr, xte, yte, k=20, chunk=128)
    assert got == want and 0 < got[0] <= got[1] <= 100


def test_linear_probe_matches_jax(monkeypatch):
    """The probe's top-1 equals JAX's, and its weights are within 1e-5 of
    JAX's (read back through JAX's test logits: test features [I; 0] give
    rows W + b and b)."""
    from sais_tpu.eval import probes as jprobes
    from sais_tpu_torch.eval.probes import train_linear_probe
    xtr, ytr = _clusters(500)
    xte, yte = _clusters(200, seed=1)
    kw = dict(num_classes=5, epochs=3, batch_size=64, lr=0.05)
    got = train_linear_probe(xtr, ytr, xte, yte, device="cpu", **kw)
    assert got["top1"] == jprobes.train_linear_probe(xtr, ytr, xte, yte,
                                                     **kw)["top1"]
    seen = []
    argmax = np.argmax

    def spy(a, *args, **kwargs):
        seen.append(np.array(a))
        return argmax(a, *args, **kwargs)

    monkeypatch.setattr(np, "argmax", spy)
    eye = np.concatenate([np.eye(32, dtype=np.float32),
                          np.zeros((1, 32), np.float32)])
    jprobes.train_linear_probe(xtr, ytr, eye, np.zeros(33, int), **kw)
    monkeypatch.undo()
    logits = seen[-1]
    b = logits[-1]
    w = logits[:-1] - b
    scale = max(np.abs(w).max(), 1.0)
    assert np.abs(got["w"] - w).max() <= 1e-5 * scale
    assert np.abs(got["b"] - b).max() <= 1e-5 * scale


def test_cosine_decay_matches_optax():
    import optax
    from sais_tpu_torch.eval.probes import cosine_decay
    sched = optax.cosine_decay_schedule(0.03, 37)
    for step in (0, 1, 18, 36, 37, 40):
        assert cosine_decay(0.03, step, 37) == pytest.approx(
            float(sched(step)), rel=1e-6, abs=1e-9)


def test_probe_features_match_jax():
    from sais_tpu.eval import probes as jprobes
    from sais_tpu.models.vit import vit_intermediate_layers
    from sais_tpu_torch.eval import probes as tprobes
    params, model, cfg = _vit()
    x = _images()
    _close(tprobes.probe_features_from_images(model, torch.from_numpy(x),
                                              n_last_blocks=2),
           jprobes.probe_features_from_images(params, jnp.asarray(x), cfg,
                                              n_last_blocks=2))
    _close(tprobes.probe_features_from_images(model, torch.from_numpy(x),
                                              n_last_blocks=1, avgpool=True),
           jprobes.probe_features_from_images(params, jnp.asarray(x), cfg,
                                              n_last_blocks=1, avgpool=True))
    toks = vit_intermediate_layers(params, jnp.asarray(x), cfg, n=2)
    with pytest.raises(ValueError, match="n_last_blocks == 1"):
        tprobes.eval_linear_features([torch.from_numpy(np.array(t))
                                      for t in toks], avgpool=True)


def _eval_root(root, videos):
    """An RGB store of `videos` (name -> frames) and a labels CSV with
    frame ranges."""
    from sais_tpu.io.feature_store import FeatureStore, rgb_store_path
    rng = np.random.default_rng(5)
    lines = ["Video,StartFrame,EndFrame,Label"]
    with FeatureStore(rgb_store_path(str(root)), "a") as fs:
        for i, (name, n) in enumerate(videos.items()):
            label = ("cut", "tie")[i % 2]
            fs.write_video(name, (rng.standard_normal((n, 24))
                                  + 2.0 * (i % 2)).astype(np.float32))
            lines.append(f"{name},0,{n // 2},{label}")
            lines.append(f"{name},{n // 2},{n + 9},{('cut', 'tie')[1 - i % 2]}")
    (root / "labels.csv").write_text("\n".join(lines) + "\n")
    return str(root / "labels.csv")


def test_cli_eval_matches_jax(tmp_path, capsys):
    """`eval --segments labels.csv` prints the JAX CLI's line; labels from a
    single video exit with its message."""
    from sais_tpu.cli import main as jcli
    from sais_tpu_torch.cli import main as tcli
    csv = _eval_root(tmp_path, {f"v{i}": 40 + 7 * i for i in range(6)})
    jcli.main(["eval", "-p", str(tmp_path), "--segments", csv])
    want = capsys.readouterr().out.strip().splitlines()[-1]
    tcli.main(["eval", "-p", str(tmp_path), "--segments", csv,
               "--device", "cpu"])
    got = capsys.readouterr().out.strip().splitlines()[-1]
    assert got.startswith("knn top1 ") and got == want
    one = tmp_path / "one"
    os.makedirs(one)
    csv1 = _eval_root(one, {"solo": 30})
    with pytest.raises(SystemExit, match="at least two videos"):
        tcli.main(["eval", "-p", str(one), "--segments", csv1,
                   "--device", "cpu"])


# ----------------------------------------------------------------- zoo --

def test_zoo_create_from_both_pth_layouts(tmp_path, monkeypatch):
    """zoo.create from a plain backbone .pth and from a DINO training
    checkpoint (student / teacher, 'module.backbone.' keys and a head),
    by name and by hubconf alias: forward within 1e-4 of JAX's create
    from the same file (the geometry patched tiny in both)."""
    from sais_tpu.models import zoo as jzoo
    from sais_tpu.models.vit import vit_features as jfeatures
    from sais_tpu_torch.models import zoo
    from sais_tpu_torch.models.vit import vit_features
    monkeypatch.setitem(jzoo.CONFIGS, "vits8", jconfig.ViTConfig(**TINY))
    monkeypatch.setitem(zoo.CONFIGS, "vits8", tconfig.ViTConfig(**TINY))
    sd = random_dino_state_dict(torch.Generator().manual_seed(3), depth=2,
                                dim=64, heads=4, patch=8, img=32)
    plain = str(tmp_path / "plain.pth")
    torch.save(sd, plain)
    nested = {f"module.backbone.{k}": v for k, v in sd.items()}
    nested["module.head.mlp.0.weight"] = torch.zeros(8, 64)
    training = str(tmp_path / "training.pth")
    torch.save({"student": nested, "teacher": nested, "epoch": 3}, training)
    x = _images(2)
    for name, path in (("vits8", plain), ("dino_vits8", training)):
        model, cfg = zoo.create(name, torch_checkpoint=path)
        params, jcfg = jzoo.create(name, torch_checkpoint=path)
        assert cfg.embed_dim == jcfg.embed_dim == 64
        with torch.no_grad():
            got = vit_features(model, torch.from_numpy(x))
        _close(got, jfeatures(params, jnp.asarray(x), jcfg))
    model, cfg = zoo.create("dino_vits8", torch.Generator().manual_seed(0))
    assert model.pos_embed.shape == (1, 17, 64)
    with pytest.raises(KeyError, match="unknown model"):
        zoo.create("vitl16")


# ----------------------------------------------------------- profiling --

def test_profiling_timer_sync_and_trace(tmp_path):
    """StageTimer's table has the JAX package's layout; device_sync is a
    no-op without a card; trace() writes a Chrome trace."""
    import re
    from sais_tpu.utils.profiling import StageTimer as JaxTimer
    from sais_tpu_torch.utils import profiling
    timers = [profiling.StageTimer(sync_device=True), JaxTimer()]
    for t in timers:
        for name in ("decode", "extract", "decode"):
            with t.stage(name):
                pass
    reports = [t.report().splitlines() for t in timers]
    assert reports[0][0] == reports[1][0]
    for a, b in zip(reports[0][1:], reports[1][1:]):
        assert a.split()[0] == b.split()[0] and a.split()[2] == b.split()[2]
        assert re.fullmatch(r"\w+ +\d+\.\d{3} +\d+ +\d+\.\d%", a)
    assert timers[0].totals().keys() == {"decode", "extract"}
    profiling.device_sync()
    with profiling.trace(str(tmp_path / "tr")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0


# --------------------------------------- retrieval, copies, segmentation --

def test_retrieval_matches_jax():
    from sais_tpu.eval import retrieval as jr
    from sais_tpu_torch.eval import retrieval as tr
    params, model, cfg = _vit()
    x = _images(4)
    _close(tr.multi_scale_features(model, torch.from_numpy(x)),
           jr.multi_scale_features(params, jnp.asarray(x), cfg))
    small = np.random.default_rng(2).random((2, 23, 17, 3)).astype(np.float32)
    _close(tr.resize_bilinear(torch.from_numpy(small), 16, 8),
           jax.image.resize(jnp.asarray(small), (2, 16, 8, 3), "bilinear"),
           1e-5)
    rng = np.random.default_rng(3)
    db, q = rng.standard_normal((40, 16)), rng.standard_normal((5, 16))
    ranks = tr.retrieval_ranks(db, q)
    assert np.array_equal(ranks, jr.retrieval_ranks(db, q))
    gnd = [{"easy": rng.choice(40, 3, replace=False),
            "hard": rng.choice(40, 2, replace=False),
            "junk": rng.choice(40, 4, replace=False)} for _ in range(5)]
    gnd[1]["easy"] = gnd[1]["hard"] = np.array([], int)
    for proto in ("medium", "hard"):
        got = tr.compute_map(ranks, tr.revisited_protocols(gnd)[proto],
                             kappas=(1, 5, 10))
        want = jr.compute_map(ranks, jr.revisited_protocols(gnd)[proto],
                              kappas=(1, 5, 10))
        assert got[0] == want[0]
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(a, b)


def test_copy_detection_matches_jax():
    from sais_tpu.eval import copy_detection as jc
    from sais_tpu_torch.eval import copy_detection as tc
    params, model, cfg = _vit()
    x = _images(6)
    feats = tc.copy_detection_features(model, torch.from_numpy(x))
    _close(feats, jc.copy_detection_features(params, jnp.asarray(x), cfg))
    feats = feats.numpy().astype(np.float64)
    whit = np.random.default_rng(4).standard_normal((30, 128))
    got = tc.whiten_and_normalize(feats[:2], feats[2:], whit)
    want = jc.whiten_and_normalize(feats[:2], feats[2:], whit)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    sims, idx = tc.rank_copies(*got)
    jsims, jidx = jc.rank_copies(*want)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_allclose(sims, jsims, atol=1e-6)
    positives = [[0, 2], [1]]
    assert tc.copydays_block_map(idx, positives) == \
        jc.copydays_block_map(jidx, positives)
    assert tc.score_ap_from_ranks([0, 3, 7], 4) == \
        jc.score_ap_from_ranks([0, 3, 7], 4)


def test_video_segmentation_matches_jax():
    from sais_tpu.eval import video_segmentation as jv
    from sais_tpu_torch.eval import video_segmentation as tv
    params, model, cfg = _vit()
    frames = _images(4)
    labels = np.random.default_rng(6).integers(0, 3, (4, 4))
    first = tv.to_one_hot(labels)
    assert np.array_equal(first, jv.to_one_hot(labels))
    assert np.array_equal(tv.restrict_neighborhood(4, 4, 1),
                          jv.restrict_neighborhood(4, 4, 1))
    got = tv.track_video(model, frames, first, n_last_frames=2, topk=3,
                         neighborhood=1)
    want = jv.track_video(params, cfg, frames, first, n_last_frames=2,
                          topk=3, neighborhood=1)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        _close(a, b)
    seg = np.random.default_rng(7).random((3, 4, 4)).astype(np.float32)
    assert np.array_equal(tv.norm_mask(seg), jv.norm_mask(seg))
