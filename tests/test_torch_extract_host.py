"""The host side of extraction in the port against the JAX package:
`--norm half` and `--exact-preprocess` through both CLIs, the host
route's frames against PIL and against the device route, the port's own
frame pump against PIL (and its fallback), and `frames` / `paths` through
both CLIs, file for file.

Limits: features of the float32 path within 1e-4 (COMPONENTS C4); the
host route's normalized frames bitwise equal to PIL's crop and resize
with the same float32 normalize, and its features bitwise equal to the
device route's; the pump's frames bitwise equal to PIL's; the frames'
JPEGs and the manifests' CSVs byte for byte.
"""

import os

import numpy as np
import pytest
import torch

from sais_tpu import config as jconfig
from sais_tpu.cli.main import main as jax_main
from sais_tpu_torch import config as tconfig
from sais_tpu_torch.cli import main as cli
from sais_tpu_torch.infer.pipeline import FeatureExtractor
from sais_tpu_torch.io import native_loader
from sais_tpu_torch.io.feature_store import FeatureStore, rgb_store_path
from sais_tpu_torch.models.vit import VisionTransformer
from sais_tpu_torch.ops.preprocess import center_crop_bounds
from tests.golden.torch_vit import random_dino_state_dict
from tests.test_torch_pipeline import _frames, _synth_video, tiny_cfg

DIM = 64


@pytest.fixture
def patched(monkeypatch):
    """Both CLIs on the tiny float32 pipeline (ViT 32 px, patch 8)."""
    jcfg, tcfg = tiny_cfg(jconfig, "float32"), tiny_cfg(tconfig, "float32")
    monkeypatch.setattr(jconfig, "PipelineConfig", lambda: jcfg)
    monkeypatch.setattr(cli, "PipelineConfig", lambda: tcfg)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A reference-layout ViT checkpoint both CLIs read (--dino-weights)."""
    path = tmp_path_factory.mktemp("w") / "vit.pth"
    torch.save(random_dino_state_dict(torch.Generator().manual_seed(0),
                                      depth=2, dim=DIM, heads=4, patch=8,
                                      img=32), path)
    return str(path)


def _root(tmp_path, name, nframes=40, h=48, w=64):
    root = tmp_path / name
    os.makedirs(root / "videos")
    _synth_video(str(root / "videos" / "vid.mp4"), nframes=nframes, h=h,
                 w=w)
    return root


def _reps(root):
    with FeatureStore(rgb_store_path(str(root))) as fs:
        return fs.read_video("vid")


@pytest.mark.parametrize("flags", [
    ["--norm", "half"], ["--exact-preprocess"],
    ["--exact-preprocess", "--norm", "half"]])
def test_cli_extract_host_flags_match_jax(tmp_path, patched, weights,
                                          flags, capsys):
    """`extract --dtype float32` with the flags, from the same checkpoint
    and video: the port's stored features within 1e-4 of the JAX CLI's;
    `--norm half` moves them (the 0.5 / 0.5 normalization is applied)."""
    args = ["extract", "-f", "vid", "--dtype", "float32", "-bs", "16",
            "--dino-weights", weights, *flags]
    jroot, troot, iroot = (_root(tmp_path, n) for n in ("j", "t", "i"))
    jax_main([*args, "-p", str(jroot)])
    cli.main([*args, "-p", str(troot), "--device", "cpu"])
    got, want = _reps(troot), _reps(jroot)
    assert got.shape == want.shape == (40, DIM)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert "extracted (40, 64)" in capsys.readouterr().out
    cli.main(["extract", "-f", "vid", "--dtype", "float32", "-bs", "16",
              "--dino-weights", weights, "-p", str(iroot), "--device",
              "cpu"])
    moved = np.abs(_reps(iroot) - got).max()
    assert (moved > 1e-3) == ("half" in flags), moved


def _pil_resized(frames, cfg):
    from PIL import Image
    out = []
    for f in frames:
        r0, r1 = center_crop_bounds(f.shape[0], cfg.crop_height_frac)
        c0, c1 = center_crop_bounds(f.shape[1], cfg.crop_width_frac)
        out.append(np.asarray(Image.fromarray(f[r0:r1, c0:c1]).resize(
            (cfg.resize, cfg.resize), Image.BILINEAR)))
    return np.stack(out)


@pytest.mark.parametrize("norm", ["imagenet", "half"])
def test_host_route_is_pil_and_the_device_route(norm):
    """`preprocess_host` (the --exact-preprocess route) on frames of odd
    and even sizes: bitwise PIL's crop and resize with the float32
    normalize (x / 255 - mean) / std; its features bitwise the device
    route's."""
    cfg = tiny_cfg(tconfig, "float32")
    if norm == "half":
        cfg = cfg.__class__(**{**cfg.__dict__, "preprocess": cfg.preprocess
                               .__class__(resize=32, mean=(0.5,) * 3,
                                          std=(0.5,) * 3)})
    model = VisionTransformer(cfg.vit)
    host = FeatureExtractor(model, cfg, batch_size=8, device="cpu",
                            exact_preprocess=True)
    dev = FeatureExtractor(model, cfg, batch_size=8, device="cpu")
    for shape in ((5, 48, 64), (3, 37, 51), (2, 101, 77)):
        frames = _frames(n=shape[0], h=shape[1], w=shape[2], seed=4)
        pre = cfg.preprocess
        want = ((_pil_resized(frames, pre).astype(np.float32)
                 / np.float32(255.0) - np.asarray(pre.mean, np.float32))
                / np.asarray(pre.std, np.float32))
        got = host.preprocess_host(frames).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(host.extract_array(frames),
                                      dev.extract_array(frames))


@pytest.mark.parametrize("h,w,out", [(48, 64, 32), (100, 140, 64),
                                     (62, 90, 48)])
def test_frame_pump_bitwise_equals_pil(tmp_path, h, w, out):
    """The port's frame pump (its own copy of the C++ source, built at
    first use into build/native/) crops and resizes each decoded frame
    bit for bit as PIL does on the frames OpenCV's Python binding decodes;
    it skips only where the build fails, as the JAX package's test."""
    from sais_tpu_torch.io.video import VideoReader
    if not native_loader.ensure_built():
        pytest.skip(f"frame pump not built: {native_loader._failed}")
    assert native_loader._LIB_PATH.startswith(os.path.join(
        os.path.dirname(native_loader._PKG), "build"))
    path = str(tmp_path / "v.mp4")
    _synth_video(path, nframes=12, h=h, w=w)
    with VideoReader(path) as r:
        frames = np.stack(list(r.frames()))
    cfg = tconfig.PreprocessConfig(resize=out)
    with native_loader.NativeFramePump(path, out_size=out) as pump:
        got = np.concatenate(list(pump.batches(5)))
        assert pump.source_size == (h, w)
    np.testing.assert_array_equal(got, _pil_resized(frames, cfg))


def test_extract_video_falls_back_with_one_line(tmp_path, monkeypatch,
                                                capsys):
    """Where the pump cannot be built, extract_video says so in one line
    and decodes with OpenCV's Python binding; the features are the pump
    route's, bitwise.  The --exact-preprocess route never asks for the
    pump."""
    cfg = tiny_cfg(tconfig, "float32")
    fx = FeatureExtractor(VisionTransformer(cfg.vit), cfg, batch_size=16,
                          device="cpu")
    root = _root(tmp_path, "r")
    video = str(root / "videos" / "vid.mp4")
    pumped = fx.extract_video(video)
    monkeypatch.setattr(native_loader, "ensure_built", lambda: False)
    fell = fx.extract_video(video)
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and "frame pump" in err[0]
    np.testing.assert_array_equal(fell, pumped)
    host = FeatureExtractor(VisionTransformer(cfg.vit), cfg, batch_size=16,
                            device="cpu", exact_preprocess=True)
    monkeypatch.setattr(host, "_pump", None)
    assert host.extract_video(video).shape == pumped.shape
    assert capsys.readouterr().err == ""


def test_cli_frames_and_paths_match_jax(tmp_path, capsys):
    """`frames` then `paths` by both CLIs on one video (40 frames: two
    flow pairs at jump 15): the same JPEG files byte for byte and the same
    two CSVs byte for byte; an empty image directory gives pandas' empty
    frame."""
    jroot, troot = _root(tmp_path, "j"), _root(tmp_path, "t")
    for run, root in ((jax_main, jroot), (cli.main, troot)):
        run(["frames", "-f", "vid", "-p", str(root)])
        run(["paths", "-f", "vid", "-p", str(root)])
    assert "wrote 40 frames" in capsys.readouterr().out
    jimg, timg = jroot / "images" / "vid", troot / "images" / "vid"
    names = sorted(os.listdir(jimg))
    assert names == sorted(os.listdir(timg)) and len(names) == 40
    assert names[0] == "frames_00000001.jpg"
    for n in names:
        assert (jimg / n).read_bytes() == (timg / n).read_bytes(), n
    for csv in ("Custom_Paths.csv", "Custom_FlowPaths.csv"):
        want = (jroot / "paths" / csv).read_text()
        assert (troot / "paths" / csv).read_text() == want, csv
    assert len((troot / "paths" / "Custom_FlowPaths.csv").read_text()
               .splitlines()) == 3
    from sais_tpu.io.manifests import write_manifests as jax_write
    from sais_tpu_torch.io.manifests import write_manifests
    for root, fn in ((jroot, jax_write), (troot, write_manifests)):
        os.makedirs(root / "images" / "empty")
        fn(str(root), ["empty"], dataset="E")
    for csv in ("E_Paths.csv", "E_FlowPaths.csv"):
        assert ((troot / "paths" / csv).read_bytes()
                == (jroot / "paths" / csv).read_bytes())
