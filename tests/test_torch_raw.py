"""The raw-video path in the port against the JAX package: the snippet
sampling grid, the crop / resize / normalize of a snippet (against the
JAX package's cv2 resize), the raw batches with flow and the TTA offsets,
R3D-18 against the golden torchvision-semantics model and JAX's, the
feature-extraction task, two epochs of RawClassificationTrainer (R3D and
ViT, frozen and unfrozen) and `train --data-type raw` through both CLIs.

Numpy-seeded frames (served from memory) and weights through the port's
converters go to both sides.  Limits: sampling grids and labels exactly;
snippets within 1e-6 of cv2's (OpenCV resizes float32 through IPP, which
sums in its own order: 2 ulp before the normalize) and bitwise equal to
numpy's float32 half-pixel bilinear; float32 features and trainers within
1e-4 (COMPONENTS C4 / C9), features relative to their largest value.
"""

import dataclasses
import pickle
import zlib

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from sais_tpu import config as jconfig
from sais_tpu.cli.main import main as jax_main
from sais_tpu.data import raw as jraw
from sais_tpu.infer import feature_task as jft
from sais_tpu.models import full_model as jfm
from sais_tpu.models import r3d as jr3d
from sais_tpu.models import vit as jvit
from sais_tpu.train import classification as jcls
from sais_tpu_torch import config as tconfig
from sais_tpu_torch.cli import main as cli
from sais_tpu_torch.data import raw as traw
from sais_tpu_torch.infer import feature_task as tft
from sais_tpu_torch.models import full_model as tfm
from sais_tpu_torch.models import r3d as tr3d
from sais_tpu_torch.models import vit as tvit
from sais_tpu_torch.port.weights import (full_model_params_from_jax,
                                         r3d18_state_from_jax,
                                         vit_params_from_jax)
from sais_tpu_torch.train import classification as tcls
from tests.golden.torch_r3d import (golden_r3d18_features,
                                    random_r3d18_state_dict)

RACES = ("Needle Handling", "Needle Driving", "Needle Withdrawal")
H, W = 40, 56


def _rows(n=12, seed=0, videos=("1", "7", "12")):
    """Stitch rows over the three RACEs, every span long enough for 16
    frames (the reference's snippets stack)."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        start = int(rng.integers(60, 300))
        entry = start + int(rng.integers(21, 120))
        wd = entry + int(rng.integers(21, 90))
        rows.append({"Video": videos[i % len(videos)],
                     "RACE": RACES[i % 3], "maj": int(rng.integers(0, 3)) % 2
                     * 2, "Domain": "NH_02",
                     "Needle Handling Start Frame": start,
                     "Needle Entry Start Frame": entry,
                     "Needle Withdrawal Start Frame": wd,
                     "Needle Withdrawal End Frame": wd + int(
                         rng.integers(30, 160))})
    return rows


def memory_source(h=H, w=W):
    """Frames from memory, a function of (video, index, modality)."""

    def load(video, indices, modality="RGB"):
        return np.stack([np.random.default_rng(
            [zlib.crc32(f"{video}/{modality}".encode()), int(i)]).integers(
                0, 256, (h, w, 3), dtype=np.uint8) for i in indices])

    return load


def test_raw_segment_indices_match_jax():
    """Every RACE, base window and TTA offsets 3 and 6 (taken from the
    raw annotation span), frame numbers without -1, cut to 16."""
    for row in _rows(30, seed=1):
        for off in (0, 3, 6):
            want = jraw.raw_segment_indices(pd.Series(row), off)
            got = traw.raw_segment_indices(row, off)
            np.testing.assert_array_equal(got, want)
            assert len(got) <= traw.RAW_SNIPPET_LEN


def _numpy_bilinear(x, oh, ow):
    """Half-pixel bilinear in numpy float32: a0 x[s] + a1 x[s + 1], edge
    taps clamped with weight 0 past the last pixel, columns then rows."""
    for axis, (n_in, n_out) in ((2, (x.shape[2], ow)), (1, (x.shape[1],
                                                            oh))):
        fx = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
        s = np.floor(fx).astype(np.int64)
        f = fx - s
        edge = (s < 0) | (s >= n_in - 1)
        f[edge] = 0
        s = np.clip(s, 0, n_in - 1)
        shape = [1] * x.ndim
        shape[axis] = n_out
        a0 = (1 - f).astype(np.float32).reshape(shape)
        a1 = f.astype(np.float32).reshape(shape)
        x = (np.take(x, s, axis) * a0
             + np.take(x, np.minimum(s + 1, n_in - 1), axis) * a1)
    return x


@pytest.mark.parametrize("shape,width", [((3, 480, 640), 112),
                                         ((2, 101, 77), 112),
                                         ((2, 37, 51), 16),
                                         ((2, 9, 13), 40)])
def test_process_snippet_matches_cv2(shape, width):
    """The 0.8 crop at int(round(...)) on odd sizes, the resize (down and
    up) and the normalize: within 1e-6 of the JAX package's cv2 path,
    bitwise numpy's half-pixel bilinear."""
    frames = np.random.default_rng(width).integers(0, 256, shape + (3,),
                                                   dtype=np.uint8)
    mean, std = traw.R3D_MEAN, traw.R3D_STD
    want = jraw.process_snippet(frames, width, mean, std)
    got = traw.process_snippet(frames, width, mean, std).numpy()
    assert got.shape == want.shape == (shape[0], width, width, 3)
    assert np.abs(got - want).max() <= 1e-6
    h, w = shape[1:]
    ch, cw = int(0.8 * h), int(0.8 * w)
    top, left = int(round((h - ch) / 2.0)), int(round((w - cw) / 2.0))
    crop = frames[:, top:top + ch, left:left + cw].astype(np.float32) / \
        np.float32(255.0)
    ref = ((_numpy_bilinear(crop, width, width) - np.asarray(mean,
                                                             np.float32))
           / np.asarray(std, np.float32))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("encoder,use_flow,tta", [
    ("R3D", False, False), ("R3D", True, True), ("ViT", True, False)])
def test_raw_batches_match_jax(encoder, use_flow, tta):
    """raw_batches over 7 rows, batch 3, shuffled: the same rows in the
    same order, labels exactly, snippets (and flow snippets at index //
    (fps // 2), no unique()) within 1e-6, the TTA variants likewise."""
    rows = _rows(7, seed=2)
    table = {"1": 20.0, "7": 30.0, "12": 25.0}
    src = memory_source()
    kw = dict(batch_size=3, shuffle=True, width=24, encoder_type=encoder,
              use_flow=use_flow, seed=4, tta=tta)
    jraw_fps = jraw.VUA_FPS_TABLE
    try:
        jraw.collate_raw.__defaults__ = (24, encoder, use_flow, 0, table)
        want = list(jraw.raw_batches(pd.DataFrame(rows), src, [0, 2],
                                     "NH_02", "train", **kw))
    finally:
        jraw.collate_raw.__defaults__ = (112, "R3D", False, 0, jraw_fps)
    orig = traw.collate_raw.__defaults__
    try:
        traw.collate_raw.__defaults__ = (24, encoder, use_flow, 0, table,
                                         None)
        got = list(traw.raw_batches(rows, src, [0, 2], "NH_02", "train",
                                    **kw))
    finally:
        traw.collate_raw.__defaults__ = orig
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w)
        np.testing.assert_array_equal(g["labels"].numpy(), w["labels"])
        for v_g, v_w in zip(g.get("tta", [g]), w.get("tta", [w])):
            for k in ("raw", "raw_flow"):
                if k in v_w:
                    assert v_g[k].shape == v_w[k].shape
                    assert np.abs(v_g[k].numpy() - v_w[k]).max() <= 1e-6


def test_missing_fps_raises_in_both():
    rows = _rows(2, videos=("nope",))
    for mod, table in ((jraw, pd.DataFrame(rows)), (traw, rows)):
        with pytest.raises(KeyError, match="fps table"):
            mod.collate_raw(table, memory_source(), [0, 2], "NH_02",
                            "train", width=16, use_flow=True)


def test_r3d18_matches_golden_and_jax():
    """8 frames of 32 x 32: the port's R3D-18 from the golden torchvision
    state_dict against the golden functional model, and from JAX's
    r3d18_init against JAX's r3d18_features, within 1e-4 of the largest
    feature; normalize_clips as JAX's."""
    gen = torch.Generator().manual_seed(0)
    sd = random_r3d18_state_dict(gen)
    clips = torch.randn(2, 3, 8, 32, 32, generator=gen)
    golden = golden_r3d18_features(sd, clips)
    model = tr3d.R3D18()
    model.load_state_dict(tr3d.r3d18_state_from_reference(sd))
    with torch.no_grad():
        got = tr3d.r3d18_features(model, clips.permute(0, 2, 3, 4, 1))
    assert got.shape == (2, 512)
    assert (got - golden).abs().max() <= 1e-4 * golden.abs().max()
    params = jr3d.r3d18_init(jax.random.key(1))
    model.load_state_dict(r3d18_state_from_jax(jax.tree.map(np.asarray,
                                                            params)))
    u8 = np.random.default_rng(2).integers(0, 256, (2, 8, 32, 32, 3),
                                           dtype=np.uint8)
    x = tr3d.normalize_clips(torch.from_numpy(u8))
    want_x = jr3d.normalize_clips(jnp.asarray(u8))
    np.testing.assert_allclose(x.numpy(), np.asarray(want_x), rtol=0,
                               atol=1e-6)
    want = np.asarray(jr3d.r3d18_features(params, want_x))
    with torch.no_grad():
        got = tr3d.r3d18_features(model, x).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


TINY_VIT = dict(image_size=24, patch_size=8, embed_dim=32, depth=2,
                num_heads=2)


def test_feature_task_matches_jax(tmp_path):
    """extract_snippet_features_vit / _r3d and run_feature_extraction at
    float32, and the all_info_dict pickle with JAX's keys and types."""
    jv = jvit.vit_init(jax.random.key(3), jconfig.ViTConfig(**TINY_VIT))
    tv = tvit.VisionTransformer(tconfig.ViTConfig(**TINY_VIT))
    tv.load_state_dict(vit_params_from_jax(jax.tree.map(np.asarray, jv)))
    snippets = np.random.default_rng(5).standard_normal(
        (2, 1, 4, 24, 24, 3)).astype(np.float32)
    want = jft.extract_snippet_features_vit(jv, snippets,
                                            jconfig.ViTConfig(**TINY_VIT),
                                            compute_dtype=jnp.float32)
    got = tft.extract_snippet_features_vit(tv, torch.from_numpy(snippets))
    assert got.shape == want.shape == (2, 1, 4, 32)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    batches = [(["a", "b"], torch.from_numpy(snippets), np.array([0, 1]))]
    info = tft.run_feature_extraction(batches, tv, "ViT")
    assert list(info) == ["snippets", "videonames", "labels"]
    assert len(info["snippets"]) == 2 and info["videonames"] == ["a", "b"]
    assert isinstance(info["snippets"][0], np.ndarray)
    dest = tft.save_all_info_dict(str(tmp_path), info, "ViT")
    assert dest.endswith("all_info_dict_ViT.pkl")
    with open(dest, "rb") as f:
        assert pickle.load(f)["videonames"] == ["a", "b"]
    jr = jr3d.r3d18_init(jax.random.key(4))
    model = tr3d.R3D18()
    model.load_state_dict(r3d18_state_from_jax(jax.tree.map(np.asarray, jr)))
    clips = np.random.default_rng(6).standard_normal(
        (1, 2, 8, 16, 16, 3)).astype(np.float32)
    want = jft.extract_snippet_features_r3d(jr, clips)
    got = tft.extract_snippet_features_r3d(model, torch.from_numpy(clips))
    assert got.shape == want.shape == (1, 2, 512)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def _raw_cfgs(encoder):
    d = 512 if encoder == "R3D" else TINY_VIT["embed_dim"]
    temporal = dict(rep_dim=TINY_VIT["embed_dim"], num_layers=1,
                    num_heads=2, ffn_dim=64, max_positions=32)
    base = dict(rep_dim=d, modalities="RGB", nclasses=2, data_type="raw")
    return (jconfig.ModelConfig(**base,
                                temporal=jconfig.TemporalConfig(**temporal)),
            tconfig.ModelConfig(**base,
                                temporal=tconfig.TemporalConfig(**temporal)))


def _trainer_pair(encoder, frozen, lr=0.05):
    jcfg, cfg = _raw_cfgs(encoder)
    params = jfm.full_model_init(jax.random.key(7), jcfg)
    model = tfm.FullModel(cfg)
    model.load_state_dict(full_model_params_from_jax(
        jax.tree.map(np.asarray, params)))
    if encoder == "R3D":
        enc = jr3d.r3d18_init(jax.random.key(8))
        tenc = tr3d.R3D18()
        tenc.load_state_dict(r3d18_state_from_jax(
            jax.tree.map(np.asarray, enc)))
        vcfg = None
    else:
        vcfg = jconfig.ViTConfig(**TINY_VIT)
        enc = jvit.vit_init(jax.random.key(8), vcfg)
        tenc = tvit.VisionTransformer(tconfig.ViTConfig(**TINY_VIT))
        tenc.load_state_dict(vit_params_from_jax(
            jax.tree.map(np.asarray, enc)))
    jt = jcls.RawClassificationTrainer(
        jcfg, jconfig.TrainConfig(lr=lr), params, enc, encoder_type=encoder,
        vit_cfg=vcfg, freeze_encoder=frozen)
    tt = tcls.RawClassificationTrainer(
        cfg, tconfig.TrainConfig(lr=lr), model, tenc, encoder_type=encoder,
        freeze_encoder=frozen, device="cpu")
    return jt, tt


@pytest.mark.parametrize("encoder,frozen", [
    ("R3D", True), ("ViT", True), ("ViT", False), ("R3D", False)])
def test_raw_trainer_matches_jax(encoder, frozen):
    """Two epochs (two train batches, one val batch with 3-way TTA) of
    16-frame snippets at 24 px from the same weights: epoch losses within
    1e-4 of their magnitude (at least 1: R3D's unnormalized 512-wide
    features make losses near 100), and after them the model's parameters (and an unfrozen
    encoder's) within 1e-4 of their largest value; a frozen encoder does
    not move and the optimizer holds only the model."""
    # R3D's features reach |x| ~ 10: a small lr keeps the unfrozen
    # encoder's BatchNorm variances positive through the steps
    jt, tt = _trainer_pair(encoder, frozen,
                           lr=1e-4 if encoder == "R3D" else 0.05)
    rows, src = _rows(9, seed=3), memory_source(32, 40)
    batches = {
        ph: [{k: (v.numpy() if k != "tta" else
                  [{kk: vv.numpy() for kk, vv in t.items()} for t in v])
              for k, v in b.items()}
             for b in traw.raw_batches(
                 rows[:6] if ph == "train" else rows[6:], src, [0, 2],
                 "NH_02", ph, 3, ph == "train", width=24,
                 encoder_type=encoder, tta=ph == "val")]
        for ph in ("train", "val")}
    enc_before = {k: v.clone() for k, v in tt.encoder.state_dict().items()}
    for _ in range(2):
        for ph in ("train", "val"):
            jl, _ = jt.run_epoch(iter(batches[ph]), ph == "train")
            tl, _ = tt.run_epoch(iter(batches[ph]), ph == "train")
            assert abs(tl - jl) <= 1e-4 * max(abs(jl), 1.0), (ph, tl, jl)
    jp = jt.params if frozen else jt.params["model"]
    want = full_model_params_from_jax(jax.tree.map(np.asarray, jp))
    for name, p in tt.model.state_dict().items():
        w = want[name].numpy()
        err = np.abs(p.numpy() - w).max()
        assert err <= 1e-4 * max(np.abs(w).max(), 1.0), name
    n_opt = sum(len(g["params"]) for g in tt.optimizer.param_groups)
    n_model = len(list(tt.model.parameters()))
    if frozen:
        assert n_opt == n_model
        for k, v in tt.encoder.state_dict().items():
            assert torch.equal(v, enc_before[k]), k
        return
    assert n_opt == n_model + len(list(tt.encoder.parameters()))
    conv = (r3d18_state_from_jax if encoder == "R3D"
            else vit_params_from_jax)
    want_enc = conv(jax.tree.map(np.asarray, jt.params["encoder"]))
    for name, p in tt.encoder.state_dict().items():
        w = want_enc[name].numpy()
        assert np.abs(p.numpy() - w).max() <= 1e-4 * max(
            np.abs(w).max(), 1.0), name
    assert any(not torch.equal(v, enc_before[k])
               for k, v in tt.encoder.state_dict().items())


def _stitch_csv(path):
    from tests.test_torch_skill import stitch_table
    rows = stitch_table(n_videos=10, stitches=2, seed=5)
    pd.DataFrame(rows).to_csv(path, index=False)
    return str(path)


@pytest.fixture
def patched(monkeypatch):
    """Both CLIs on a tiny pipeline (ViT 24 px, patch 8, width 32; a
    1-layer temporal model), frames served from memory by both packages'
    jpeg_frame_source, the port's initializers drawing JAX's weights
    (model: fold key; encoders: key 5), every run_epoch's (train, loss)
    recorded."""
    dim = TINY_VIT["embed_dim"]
    temporal = dict(rep_dim=dim, num_layers=1, num_heads=2, ffn_dim=64,
                    max_positions=32)
    cfgs = {}
    for name, mod in (("jax", jconfig), ("port", tconfig)):
        cfgs[name] = mod.PipelineConfig(
            vit=mod.ViTConfig(**TINY_VIT),
            model=mod.ModelConfig(rep_dim=dim,
                                  temporal=mod.TemporalConfig(**temporal)),
            compute_dtype="float32")
    monkeypatch.setattr(jconfig, "PipelineConfig", lambda: cfgs["jax"])
    monkeypatch.setattr(cli, "PipelineConfig", lambda: cfgs["port"])
    for mod in (jraw, traw):
        monkeypatch.setattr(mod, "jpeg_frame_source",
                            lambda root, dataset="VUA": memory_source(30, 40))

    def _jcfg(cfg):
        fields = {f.name: getattr(cfg, f.name)
                  for f in dataclasses.fields(cfg) if f.name != "temporal"}
        return jconfig.ModelConfig(**fields, temporal=jconfig.TemporalConfig(
            **dataclasses.asdict(cfg.temporal)))

    def init(generator, cfg):
        fold = generator.initial_seed() // 2
        tree = jfm.full_model_init(
            jax.random.fold_in(jax.random.key(0), fold), _jcfg(cfg))
        model = tfm.FullModel(cfg)
        model.load_state_dict(full_model_params_from_jax(
            jax.tree.map(np.asarray, tree)))
        return model

    def r3d_init(generator):
        model = tr3d.R3D18()
        model.load_state_dict(r3d18_state_from_jax(jax.tree.map(
            np.asarray, jr3d.r3d18_init(jax.random.key(5)))))
        return model

    def vit_init(generator, cfg):
        model = tvit.VisionTransformer(cfg)
        model.load_state_dict(vit_params_from_jax(jax.tree.map(
            np.asarray, jvit.vit_init(jax.random.key(5), cfgs["jax"].vit))))
        return model

    monkeypatch.setattr(tfm, "full_model_init", init)
    monkeypatch.setattr(tr3d, "r3d18_init", r3d_init)
    monkeypatch.setattr(tvit, "vit_init", vit_init)
    record = {"jax": [], "port": []}
    for name, klass in (("jax", jcls.ClassificationTrainer),
                        ("port", tcls.ClassificationTrainer)):
        def run(self, batches, train, _orig=klass.run_epoch,
                _out=record[name]):
            loss, m = _orig(self, batches, train)
            _out.append((train, loss))
            return loss, m
        monkeypatch.setattr(klass, "run_epoch", run)
    return record


@pytest.mark.parametrize("flags", [
    ["--encoder", "ViT"], ["--encoder", "ViT", "--unfreeze-encoder"],
    pytest.param(["--encoder", "R3D"], marks=pytest.mark.slow),
    pytest.param(["--encoder", "R3D", "--unfreeze-encoder"],
                 marks=pytest.mark.slow)])
def test_cli_train_raw_matches_jax(tmp_path, patched, flags, capsys):
    """`train --dataset vua-ease --data-type raw -e 2 -bs 4 --raw-width
    24` by both CLIs: the same epochs with losses within 1e-4 (relative
    past 1) and
    params.pkl's leaves within 1e-4 (the joint {model, encoder} tree with
    --unfreeze-encoder); with --dataset vua-ease-stitch both exit.  R3D
    takes lr 1e-4 (see test_raw_trainer_matches_jax)."""
    import os
    segs = _stitch_csv(tmp_path / "stitch.csv")
    args = ["train", "-p", str(tmp_path), "--segments", segs, "--dataset",
            "vua-ease", "--data-type", "raw", "-e", "2", "-bs", "4",
            "--raw-width", "24", "-lr",
            "1e-4" if "R3D" in flags else "0.05", *flags]
    pkl = os.path.join(tmp_path, "params", "Fold_0", "params.pkl")

    def params():
        with open(pkl, "rb") as f:
            return pickle.load(f)

    jax_main(args)
    want = params()
    cli.main([*args, "--device", "cpu"])
    got = params()
    assert "saved fold 0" in capsys.readouterr().out
    jrec, trec = patched["jax"], patched["port"]
    assert [t for t, _ in trec] == [t for t, _ in jrec] and len(jrec) >= 4
    np.testing.assert_allclose([l for _, l in trec], [l for _, l in jrec],
                               rtol=1e-4, atol=1e-4)
    assert jax.tree.structure(got) == jax.tree.structure(
        jax.tree.map(np.asarray, want))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w)
        assert np.abs(g - w).max() <= 1e-4 * max(np.abs(w).max(), 1.0)
    bad = list(args)
    bad[bad.index("vua-ease")] = "vua-ease-stitch"
    for run in (jax_main, lambda a: cli.main([*a, "--device", "cpu"])):
        with pytest.raises(SystemExit, match="vua-ease"):
            run(bad)
