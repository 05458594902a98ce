"""`port` in the port against the JAX package on the CPU: the params.zip ->
params.pkl -> params.zip conversion read by both CLIs, and the golden
digests of `port/verify.py` (a digest either package records verifies in
the other; a different file and a drifting probe fail).  The probes run
at a tiny ViT geometry, patched into both packages' configs."""

import os
import pickle
import shutil

import numpy as np
import pytest
import torch

import jax

from sais_tpu import config as jconfig
from sais_tpu.models.full_model import full_model_init, prototypes_init
from sais_tpu.port import verify as jverify
from sais_tpu.port.torch_port import load_torch_pickle
from sais_tpu.train.checkpoint import (export_torch_prototypes,
                                       export_torch_state_dict)
from sais_tpu_torch import config as tconfig
from sais_tpu_torch.port import verify as tverify
from tests.golden.torch_vit import random_dino_state_dict

TINY = dict(image_size=224, patch_size=16, embed_dim=64, depth=2,
            num_heads=4)


def _reference_fold(d, seed=0):
    """A fold in the reference's layout (params.zip + prototypes.zip),
    written by the JAX package's exporters; returns its params."""
    os.makedirs(d, exist_ok=True)
    params = full_model_init(jax.random.key(seed),
                             jconfig.ModelConfig(modalities="RGB"))
    keys, protos = prototypes_init(jax.random.key(seed + 1), 2)
    sd = export_torch_state_dict(params)
    pd = export_torch_prototypes(keys, protos)
    torch.save({k: torch.tensor(np.asarray(v)) for k, v in sd.items()},
               os.path.join(d, "params.zip"))
    torch.save({k: torch.tensor(np.asarray(v)) for k, v in pd.items()},
               os.path.join(d, "prototypes.zip"))
    return params, np.asarray(protos)


def _same_tree(a, b):
    flat_a, tree_a = jax.tree_util.tree_flatten(a)
    flat_b, tree_b = jax.tree_util.tree_flatten(b)
    assert tree_a == tree_b
    for x, y in zip(flat_a, flat_b):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _load(d, name):
    with open(os.path.join(d, name), "rb") as f:
        return pickle.load(f)


def test_port_conversion_round_trip_read_by_both_clis(tmp_path, capsys):
    """zip -> pkl by the port equals the JAX CLI's pkl; pkl -> zip by the
    port equals the JAX CLI's zip; and the port's zip decodes in both
    packages' fold loaders to the original weights."""
    from sais_tpu.cli import main as jcli
    from sais_tpu_torch.cli import main as tcli
    params, protos = _reference_fold(tmp_path / "port" / "Fold_0")
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    tcli.main(["port", "--params-dir", str(tmp_path / "port"),
               "--device", "cpu"])
    jcli.main(["port", "--params-dir", str(tmp_path / "jax")])
    assert "converted torch -> native" in capsys.readouterr().out
    for name in ("params.pkl", "prototypes.pkl"):
        _same_tree(_load(tmp_path / "port" / "Fold_0", name),
                   _load(tmp_path / "jax" / "Fold_0", name))
    _same_tree(_load(tmp_path / "port" / "Fold_0", "params.pkl"),
               jax.tree_util.tree_map(np.asarray, params))
    # and back: only the pickles left, each CLI writes the zips
    for root in ("port", "jax"):
        for name in ("params.zip", "prototypes.zip"):
            os.unlink(tmp_path / root / "Fold_0" / name)
    tcli.main(["port", "--params-dir", str(tmp_path / "port" / "Fold_0"),
               "--device", "cpu"])
    jcli.main(["port", "--params-dir", str(tmp_path / "jax" / "Fold_0")])
    assert "converted native -> torch" in capsys.readouterr().out
    for name in ("params.zip", "prototypes.zip"):
        a = load_torch_pickle(str(tmp_path / "port" / "Fold_0" / name))
        b = load_torch_pickle(str(tmp_path / "jax" / "Fold_0" / name))
        assert list(a) == list(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    # the port's zips read back by the JAX converter and the port's loader
    from sais_tpu.port.torch_port import full_model_params_from_torch
    _same_tree(jax.tree_util.tree_map(np.asarray, full_model_params_from_torch(
        load_torch_pickle(str(tmp_path / "port" / "Fold_0" / "params.zip")))),
        jax.tree_util.tree_map(np.asarray, params))
    os.unlink(tmp_path / "port" / "Fold_0" / "params.pkl")
    model, got = tcli.load_fold(str(tmp_path / "port" / "Fold_0"),
                                tconfig.PipelineConfig())
    np.testing.assert_array_equal(got.numpy(), protos)


@pytest.fixture
def tiny_vit(monkeypatch, tmp_path):
    """The `vit` kind at a small geometry in both packages, and a
    reference-layout checkpoint of it."""
    monkeypatch.setattr(jconfig, "ViTConfig", _jvit)
    monkeypatch.setattr(tconfig, "ViTConfig", _tvit)
    sd = random_dino_state_dict(torch.Generator().manual_seed(7), depth=2,
                                dim=64, heads=4, patch=16, img=224)
    path = str(tmp_path / "dino_deitsmall16_pretrain.pth")
    torch.save(sd, path)
    return path


_JVIT, _TVIT = jconfig.ViTConfig, tconfig.ViTConfig


def _jvit():
    return _JVIT(**TINY)


def _tvit():
    return _TVIT(**TINY)


def test_digests_cross_verify_between_packages(tiny_vit, tmp_path):
    """A digest the JAX package records verifies in the port and the
    reverse, within ATOL; the port's probe inputs are JAX's."""
    np.testing.assert_array_equal(tverify.probe_images(),
                                  jverify.probe_images())
    for a, b in zip(tverify.probe_frame_pair(), jverify.probe_frame_pair()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tverify.probe_window()["rgb"],
                                  jverify.probe_window()["rgb"])
    jdir, tdir = str(tmp_path / "jgold"), str(tmp_path / "tgold")
    jverify.record(tiny_vit, "vit", golden_dir=jdir)
    errs = tverify.verify(tiny_vit, "vit", golden_dir=jdir, device="cpu")
    assert errs["features"] <= 1e-4
    tverify.record(tiny_vit, "vit", golden_dir=tdir, device="cpu")
    assert jverify.verify(tiny_vit, "vit", golden_dir=tdir)["features"] \
        <= 1e-4
    assert tverify.verify(tiny_vit, "vit", golden_dir=tdir,
                          device="cpu")["features"] == 0.0


def test_full_kind_cross_verifies(tmp_path):
    """The `full` kind probes params.zip and the prototypes.zip beside it:
    a JAX-recorded digest verifies in the port."""
    _reference_fold(tmp_path / "f")
    ppath = str(tmp_path / "f" / "params.zip")
    gdir = str(tmp_path / "gold")
    jverify.record(ppath, "full", golden_dir=gdir)
    errs = tverify.verify(ppath, "full", golden_dir=gdir, device="cpu")
    assert set(errs) == {"video_rep", "probs"}
    assert max(errs.values()) <= 1e-4


def test_verify_fails_on_another_file_and_on_drift(tiny_vit, tmp_path,
                                                   monkeypatch):
    gdir = str(tmp_path / "gold")
    tverify.record(tiny_vit, "vit", golden_dir=gdir, device="cpu")
    sd = torch.load(tiny_vit, weights_only=False)
    sd["cls_token"] = sd["cls_token"] + 1e-3
    other = str(tmp_path / "perturbed.pth")
    torch.save(sd, other)
    with pytest.raises(ValueError, match="SHA256 mismatch"):
        tverify.verify(other, "vit", golden_dir=gdir, device="cpu")
    real = tverify._run_vit

    def drifting(path, device):
        out = real(path, device)
        out["features"] = out["features"] + 0.01
        return out

    monkeypatch.setitem(tverify._RUNNERS, "vit", drifting)
    with pytest.raises(AssertionError, match="port drift"):
        tverify.verify(tiny_vit, "vit", golden_dir=gdir, device="cpu")
    with pytest.raises(FileNotFoundError, match="--record"):
        tverify.verify(tiny_vit, "raft", golden_dir=gdir, device="cpu")
    with pytest.raises(ValueError, match="unknown kind"):
        tverify.verify(tiny_vit, "i3d", golden_dir=gdir, device="cpu")


def test_cli_port_verify_record_and_record_all(tiny_vit, tmp_path, capsys):
    from sais_tpu_torch.cli import main as tcli
    gdir = str(tmp_path / "gold")
    cpu = ["--device", "cpu", "--golden-dir", gdir]
    tcli.main(["port", "--record", tiny_vit, "--kind", "vit", *cpu])
    assert "recorded golden digest" in capsys.readouterr().out
    tcli.main(["port", "--verify", tiny_vit, "--kind", "vit", *cpu])
    out = capsys.readouterr().out
    assert "vit/features: max|Δ| = 0.000e+00" in out
    assert "port verified" in out
    with pytest.raises(SystemExit, match="--kind"):
        tcli.main(["port", "--verify", tiny_vit, "--device", "cpu"])
    ckdir = tmp_path / "checkpoints"
    ckdir.mkdir()
    shutil.copy(tiny_vit, ckdir / "dino_deitsmall16_pretrain.pth")
    gdir2 = str(tmp_path / "gold2")
    tcli.main(["port", "--record-all", str(ckdir), "--device", "cpu",
               "--golden-dir", gdir2])
    out = capsys.readouterr().out
    assert "vit: recorded" in out
    assert "raft: NOT FOUND" in out and "ptlflow" in out
    assert "full: NOT FOUND" in out
    assert os.path.exists(tverify.golden_path("vit", gdir2))
    with pytest.raises(SystemExit, match="no checkpoints discovered"):
        tcli.main(["port", "--record-all", str(tmp_path / "gold2"),
                   "--device", "cpu"])
    (tmp_path / "Fold_0").mkdir()
    for name in ("raft_things.ckpt", "Fold_0/params.zip", "notes.txt"):
        (tmp_path / name).write_bytes(b"x")
    assert tverify.discover_checkpoints(str(tmp_path)) == \
        jverify.discover_checkpoints(str(tmp_path))
