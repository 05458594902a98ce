"""The port's flow stream against the JAX package on the CPU: the flow
renderer, `FlowExtractor` (RAFT -> flow RGB -> DINO reps, array and
streaming paths) and the CLI's `flow`, `pipeline -mod RGB-Flow`, `decode`
and `steps` with flow, and `pretrain --source flows`.  Weights are made
once and read by both packages (`raft_state_from_jax`,
`vit_params_from_jax`, or reference-layout checkpoints for the CLIs)."""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from sais_tpu import config as jconfig
from sais_tpu.infer.pipeline import FlowExtractor as JaxFlowExtractor
from sais_tpu.models.full_model import full_model_init as jax_model_init
from sais_tpu.models.full_model import prototypes_init as jax_protos_init
from sais_tpu.models.raft import raft_init as jax_raft_init
from sais_tpu.models.vit import vit_init as jax_vit_init
from sais_tpu.ops import flow_viz as jviz
from sais_tpu.train.checkpoint import save_training_result
from sais_tpu_torch import config as tconfig
from sais_tpu_torch.infer import pipeline as tpipeline
from sais_tpu_torch.infer.pipeline import FlowExtractor
from sais_tpu_torch.models.raft import RAFT
from sais_tpu_torch.models.vit import VisionTransformer, vit_init
from sais_tpu_torch.ops import flow_viz
from sais_tpu_torch.port.weights import raft_state_from_jax, \
    vit_params_from_jax
from tests.golden.torch_raft import random_raft_state_dict

DIM = 48


def tiny_cfg(cfgmod, dtype="float32", iters=2):
    """The JAX flow-stream tests' configuration (tests/test_flow_stream.py)
    with a two-layer temporal model of the same width."""
    return cfgmod.PipelineConfig(
        vit=cfgmod.ViTConfig(image_size=32, patch_size=8, embed_dim=DIM,
                             depth=1, num_heads=4),
        preprocess=cfgmod.PreprocessConfig(resize=32),
        model=cfgmod.ModelConfig(
            rep_dim=DIM, temporal=cfgmod.TemporalConfig(
                rep_dim=DIM, num_layers=2, num_heads=4, ffn_dim=128)),
        raft=cfgmod.RAFTConfig(iters=iters),
        compute_dtype=dtype)


def _tiny_jax_cfg():
    """A stand-in for sais_tpu.config.PipelineConfig in the JAX CLI."""
    cfg = tiny_cfg(jconfig)
    return lambda: cfg


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# The renderer
# ---------------------------------------------------------------------------

def test_colorwheel_and_anchor_colours():
    """The anchors and zero-flow cases of tests/test_flow_stream.py, exact,
    and the wheel equal to the JAX package's."""
    w = flow_viz.make_colorwheel()
    np.testing.assert_array_equal(w, jviz.make_colorwheel())
    assert w.shape == (55, 3)
    np.testing.assert_array_equal(w[0], [255, 0, 0])
    np.testing.assert_array_equal(w[15], [255, 255, 0])
    np.testing.assert_array_equal(
        flow_viz.flow_to_rgb(np.zeros((4, 4, 2)), flow_max_radius=1.0), 1.0)
    flow = np.zeros((1, 2, 2))
    flow[..., 0] = [2.0, 0.0]
    rgb = flow_viz.flow_to_rgb(flow)
    np.testing.assert_array_equal(rgb[0, 0], [1.0, 0.0, 0.0])
    np.testing.assert_array_equal(rgb[0, 1], [1.0, 1.0, 1.0])
    u8 = flow_viz.flow_to_rgb_uint8(flow)
    assert u8.dtype == np.uint8 and u8[0, 0, 0] == 255
    dev = flow_viz.flow_to_rgb_device(torch.tensor(flow[None]))
    np.testing.assert_array_equal(dev.numpy()[0], u8)
    zero = flow_viz.flow_to_rgb_device(torch.zeros(2, 3, 5, 2))
    assert (zero == 255).all()


def test_renderers_agree_with_jax_and_numpy():
    """The port's numpy renderer equals JAX's bit for bit; its device
    renderer is within 1 uint8 level of the numpy one and of JAX's device
    renderer, with per-image maxima, a zero patch, NaN and inf."""
    rng = np.random.default_rng(3)
    flow = (rng.standard_normal((5, 33, 47, 2)) * 7).astype(np.float32)
    flow[0] *= 0.01
    flow[1, :4, :4] = 0
    flow[2, 3, 5] = np.nan
    flow[2, 7, 1, 0] = np.inf
    flow[3, 0, 0, 1] = -np.inf
    host = np.stack([flow_viz.flow_to_rgb_uint8(f) for f in flow])
    np.testing.assert_array_equal(
        host, np.stack([jviz.flow_to_rgb_uint8(f) for f in flow]))
    dev = flow_viz.flow_to_rgb_device(torch.from_numpy(flow)).numpy()
    jdev = np.asarray(jviz.flow_to_rgb_device(jnp.asarray(flow)))
    for other in (host, jdev):
        diff = np.abs(dev.astype(int) - other.astype(int))
        assert diff.max() <= 1
        assert (diff == 0).mean() > 0.999
    assert (dev[2, 3, 5] == 0).all() and (dev[2, 7, 1] == 0).all()


# ---------------------------------------------------------------------------
# FlowExtractor
# ---------------------------------------------------------------------------

def _frames(n, h, w, seed):
    return np.random.default_rng(seed).integers(0, 255, (n, h, w, 3),
                                                dtype=np.uint8)


@pytest.fixture(scope="module")
def extractors():
    """(JAX extractor, port extractor, 60 frames, JAX's extract output and
    flow fields of the first 40) at the JAX flow test's size: f32, pair
    batch 2, RAFT iters 2."""
    jcfg, tcfg = tiny_cfg(jconfig), tiny_cfg(tconfig)
    raft = jax_raft_init(jax.random.key(0), jcfg.raft)
    vit = jax_vit_init(jax.random.key(1), jcfg.vit)
    jfx = JaxFlowExtractor(raft, vit, jcfg, pair_batch=2)
    traft = RAFT(tcfg.raft)
    traft.load_state_dict(raft_state_from_jax(_np_tree(raft)))
    tvit = VisionTransformer(tcfg.vit)
    tvit.load_state_dict(vit_params_from_jax(_np_tree(vit)))
    fx = FlowExtractor(traft, tvit, tcfg, pair_batch=2, device="cpu")
    frames = _frames(60, 128, 136, seed=0)
    return (jfx, fx, frames, jfx.extract(frames[:40]),
            jfx.flow_fields(frames[:40]))


def test_same_flow_fields_give_same_reps(extractors):
    """JAX's flow fields rendered and embedded by the port give JAX's
    reps within 1e-4 (f32 ViT parity)."""
    _, fx, _, (jreps, jrgb), jfields = extractors
    rgb = np.stack([flow_viz.flow_to_rgb_uint8(f) for f in jfields])
    np.testing.assert_array_equal(rgb, jrgb)
    np.testing.assert_allclose(fx._features.extract_array(rgb), jreps,
                               atol=1e-4)


def test_extract_matches_jax(extractors):
    """The whole `extract`: 40 frames at jump 15 give pairs (0, 15) and
    (15, 30); flow RGB within 1 level, reps within 1e-2 of the largest."""
    _, fx, frames, (jreps, jrgb), jfields = extractors
    fields = fx.flow_fields(frames[:40])
    np.testing.assert_allclose(fields, jfields, rtol=1e-3, atol=2e-3)
    reps, rgb = fx.extract(frames[:40])
    assert reps.shape == (2, DIM) and rgb.shape == (2, 128, 136, 3)
    assert np.abs(rgb.astype(int) - jrgb.astype(int)).max() <= 1
    assert np.abs(reps - jreps).max() <= 1e-2 * np.abs(jreps).max()


@pytest.mark.parametrize("n", [40, 30, 31, 45, 46, 59])
def test_stream_equals_array_path(extractors, n):
    """extract_video over a frame iterator (the fused route: rendered on the
    device) pairs exactly as the array path at awkward lengths (k * jump,
    k * jump + 1, ...), gives its reps within 1e-5 (JAX's limit) and
    buffers at most pair_batch pairs."""
    _, fx, frames, _, _ = extractors
    sub = frames[:n]
    ref, _ = fx.extract(sub)
    got = fx.extract_video(None, frame_source=iter(sub), save_flow_dir=None)
    assert got.shape == ref.shape
    assert fx.peak_buffered_pairs <= fx.pair_batch
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_staged_stream_saves_flow_images(extractors, tmp_path):
    """With save_flow_dir the stream renders on the host, writes
    flows_%08d.jpg numbered by pair index and gives the array path's reps
    exactly."""
    _, fx, frames, _, _ = extractors
    ref, _ = fx.extract(frames[:59])
    got = fx.extract_video(None, frame_source=iter(frames[:59]),
                           save_flow_dir=str(tmp_path / "flows"))
    np.testing.assert_allclose(got, ref, atol=1e-6)
    assert sorted(os.listdir(tmp_path / "flows")) == [
        f"flows_{i:08d}.jpg" for i in range(3)]


def test_ragged_tail_runs_one_raft_shape(extractors, monkeypatch):
    """50 frames at jump 15 are 3 pairs: a full batch of 2 and a tail of 1,
    padded to 2, so RAFT sees one input shape on both routes."""
    _, fx, _, _, _ = extractors
    shapes = set()
    real = tpipeline.raft_forward

    def spy(model, a, b, *args, **kw):
        shapes.add(tuple(a.shape))
        return real(model, a, b, *args, **kw)

    monkeypatch.setattr(tpipeline, "raft_forward", spy)
    frames = _frames(50, 64, 72, seed=1)
    assert fx.flow_fields(frames).shape[0] == 3
    assert fx.extract_video(None, frame_source=iter(frames)).shape[0] == 3
    assert shapes == {(2, 64, 72, 3)}


def test_stream_reraises_producer_errors(extractors):
    """A decode failure in the producer thread surfaces, not an early EOF;
    a missing video raises before any thread starts."""
    _, fx, frames, _, _ = extractors

    def broken():
        yield from frames[:20]
        raise RuntimeError("corrupt frame 20")

    with pytest.raises(RuntimeError, match="corrupt frame 20"):
        fx.extract_video(None, frame_source=broken())
    with pytest.raises(FileNotFoundError):
        fx.extract_video("/nonexistent/video.mp4")


def test_flow_resize_resizes_before_raft(extractors):
    """flow_resize (H, W) resizes every frame with cv2 before RAFT, on the
    array and the streaming path alike."""
    import cv2
    _, fx, frames, _, _ = extractors
    sized = FlowExtractor(fx.raft, fx._features.model.float(), fx.cfg,
                          pair_batch=2, flow_resize=(48, 56), device="cpu")
    small = np.stack([cv2.resize(f, (56, 48)) for f in frames[:31]])
    ref = fx.flow_fields(small)
    got = sized.flow_fields(frames[:31])
    assert got.shape == (2, 48, 56, 2)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(
        sized.extract_video(None, frame_source=iter(frames[:31])),
        fx.extract(small)[0], atol=1e-5)


def test_auto_pair_batch_rule(extractors):
    """The JAX package's rule: the f32 level-0 volume under 2 GB, at most
    8 pairs."""
    jfx, fx, _, _, _ = extractors
    saved = fx.pair_batch, jfx.pair_batch
    try:
        fx.pair_batch = jfx.pair_batch = None
        for h, w in ((480, 640), (1080, 1920), (720, 1280), (64, 72)):
            assert fx.auto_pair_batch(h, w) == jfx.auto_pair_batch(h, w)
        assert fx.auto_pair_batch(480, 640) == 8
    finally:
        fx.pair_batch, jfx.pair_batch = saved


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def _synth_video(path, nframes=60, h=48, w=64, fps=30):
    """A textured frame that slides two pixels a frame to the right."""
    import cv2
    base = np.random.default_rng(4).integers(0, 256, (h, w + 2 * nframes, 3),
                                             dtype=np.uint8)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (w, h))
    assert writer.isOpened()
    for i in range(nframes):
        off = 2 * (nframes - i)
        writer.write(np.ascontiguousarray(base[:, off:off + w, ::-1]))
    writer.release()


def _save_jax_fold(path, nclasses, seed):
    jcfg = tiny_cfg(jconfig)
    params = jax_model_init(jax.random.key(seed), jcfg.model)
    _, protos = jax_protos_init(jax.random.key(seed + 1), nclasses)
    save_training_result(str(path), {"model": params, "prototypes": protos,
                                     "metrics": {}})


@pytest.fixture(scope="module")
def jax_root(tmp_path_factory):
    """A root the JAX CLI filled: videos/vid.mp4, the RGB store (`extract
    --exact-preprocess`) and the flow store (`flow --flow-jump auto`),
    f32, from reference-layout RAFT and ViT checkpoints that the port's
    CLI reads too; folds for decode (2 classes) and steps (3)."""
    from sais_tpu.cli.main import main as jax_main
    root = tmp_path_factory.mktemp("jaxroot")
    os.makedirs(root / "videos")
    _synth_video(str(root / "videos" / "vid.mp4"))
    torch.save(random_raft_state_dict(torch.Generator().manual_seed(0)),
               root / "raft.pth")
    torch.save(vit_init(torch.Generator().manual_seed(1),
                        tiny_cfg(tconfig).vit).state_dict(), root / "vit.pth")
    common = ["-f", "vid", "-p", str(root), "--dtype", "float32",
              "--dino-weights", str(root / "vit.pth")]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jconfig, "PipelineConfig", _tiny_jax_cfg())
        jax_main(["extract", "--exact-preprocess", *common])
        jax_main(["flow", "--raft-weights", str(root / "raft.pth"),
                  "--flow-iters", "2", "--flow-jump", "auto", *common])
    _save_jax_fold(root / "params2" / "Fold_0", 2, seed=10)
    _save_jax_fold(root / "params3" / "Fold_0", 3, seed=20)
    return root


@pytest.fixture
def port_cli(monkeypatch):
    from sais_tpu_torch.cli import main as cli
    cfg = tiny_cfg(tconfig)
    monkeypatch.setattr(cli, "PipelineConfig", lambda: cfg)
    return cli


def _read_store(path, video="vid"):
    import h5py
    with h5py.File(path, "r") as f:
        return np.asarray(f[video]), dict(f[video].attrs)


def test_cli_flow_matches_jax_cli(jax_root, port_cli, tmp_path, capsys):
    """`flow --flow-jump auto` on the same mp4 and checkpoints: the port's
    flow store holds the JAX CLI's reps within the extract limit (1e-2 of
    the largest) and the same flow_jump attr, read from the fps."""
    from sais_tpu_torch.io.feature_store import flow_store_path
    os.makedirs(tmp_path / "videos")
    os.link(jax_root / "videos" / "vid.mp4", tmp_path / "videos" / "vid.mp4")
    port_cli.main(["flow", "-f", "vid", "-p", str(tmp_path), "--device",
                   "cpu", "--dtype", "float32", "--flow-iters", "2",
                   "--flow-jump", "auto",
                   "--raft-weights", str(jax_root / "raft.pth"),
                   "--dino-weights", str(jax_root / "vit.pth")])
    out = capsys.readouterr().out
    assert "flow jump 15 (fps 30)" in out and "flow reps (3, 48)" in out
    got, attrs = _read_store(flow_store_path(str(tmp_path)))
    ref, jattrs = _read_store(flow_store_path(str(jax_root)))
    assert attrs == jattrs == {"flow_jump": 15}
    assert got.shape == ref.shape == (3, DIM)
    assert np.abs(got - ref).max() <= 1e-2 * np.abs(ref).max()
    port_cli.main(["flow", "-f", "vid", "-p", str(tmp_path), "--device",
                   "cpu", "--random-init"])
    assert "flow reps exist, skipping" in capsys.readouterr().out


def _decode_artifacts(root, run, flags):
    run(["decode", "-f", "vid", "-p", str(root), "-mod", "RGB-Flow",
         "--params-dir", str(root / "params2"), "--save-artifacts", *flags])
    with open(root / "params" / "Fold_0"
              / "reps_and_labels_Custom_inference.pkl", "rb") as f:
        probs = pickle.load(f)["probs"]
    csv = (root / "results" / "Custom_inference_gestures.csv").read_text()
    return csv, np.stack([probs[t] for t in sorted(probs)])


def test_cli_decode_rgb_flow_on_jax_stores(jax_root, port_cli, capsys):
    """`decode -mod RGB-Flow --save-artifacts` over the JAX CLI's stores
    and a JAX-trained fold: the port writes the JAX CLI's CSV text, and
    its window probabilities agree within 1e-3 (port/verify.py:55)."""
    from sais_tpu.cli.main import main as jax_main
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jconfig, "PipelineConfig", _tiny_jax_cfg())
        jcsv, jprobs = _decode_artifacts(jax_root, jax_main, [])
    csv, probs = _decode_artifacts(jax_root, port_cli.main,
                                   ["--device", "cpu"])
    assert "gesture intervals" in capsys.readouterr().out
    assert csv == jcsv
    assert probs.shape == jprobs.shape == (3, 4, 2)
    np.testing.assert_allclose(probs, jprobs, atol=1e-3)


def test_cli_steps_flow_on_jax_stores(jax_root, port_cli, capsys):
    """`steps -mod Flow --fps 2` on the JAX CLI's stores: the stride of the
    flow store (15) is adopted over the steps default (fps // 2 = 1); the
    same rows as the JAX CLI's CSV, probabilities within 1e-3."""
    from sais_tpu.cli.main import main as jax_main
    argv = ["steps", "-f", "vid", "-p", str(jax_root), "-mod", "Flow",
            "--fps", "2", "--params-dir", str(jax_root / "params3")]
    csv = jax_root / "results" / "vid_steps.csv"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jconfig, "PipelineConfig", _tiny_jax_cfg())
        jax_main(argv)
    ref = pd.read_csv(csv, index_col=0)
    capsys.readouterr()
    port_cli.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "flow jump 15 (recorded by extraction)" in out
    got = pd.read_csv(csv, index_col=0)
    assert len(got) == len(ref) == 5
    classes = ["Needle Handling", "Needle Driving", "Needle Withdrawal"]
    keys = ["Video", "StartFrame", "EndFrame", "Step"]
    pd.testing.assert_frame_equal(got[keys], ref[keys])
    np.testing.assert_allclose(got[classes], ref[classes], atol=1e-3)


def test_cli_flow_jump_reconciliation(jax_root, port_cli, capsys):
    """A --flow-jump that contradicts the store's stride exits; a store
    written at --flow-jump 10 makes decode adopt 10; --flow-jump auto with
    no video exits cleanly."""
    argv = ["decode", "-f", "vid", "-p", str(jax_root), "-mod", "RGB-Flow",
            "--params-dir", str(jax_root / "params2"), "--device", "cpu"]
    with pytest.raises(SystemExit, match="contradicts"):
        port_cli.main(argv + ["--flow-jump", "5"])
    with pytest.raises(SystemExit, match="needs the source video"):
        port_cli.main(["decode", "-f", "absent", "-p", str(jax_root),
                       "--random-init", "--device", "cpu",
                       "--flow-jump", "auto"])
    from sais_tpu_torch.io.feature_store import FeatureStore, flow_store_path
    store = flow_store_path(str(jax_root))
    with FeatureStore(store) as fs:
        reps = fs.read_video("vid")
    with FeatureStore(store, "a") as fs:
        fs.write_video("vid10", reps, attrs={"flow_jump": 10})
        assert "vid10" in fs and fs.video_attr("vid10", "flow_jump") == 10
        assert fs.video_attr("nothing", "flow_jump") is None
    args = port_cli.build_parser().parse_args(
        ["decode", "-f", "vid10", "-p", str(jax_root), "-mod", "RGB-Flow"])
    cfg = port_cli._pipeline_config(args)
    assert cfg.window.flow_jump_factor == 15
    assert port_cli._reconcile_flow_jump(
        cfg, args, "vid10").window.flow_jump_factor == 10
    assert "flow jump 10 (recorded by extraction)" in capsys.readouterr().out
    assert args.flow_jump == "10"


def test_cli_pipeline_rgb_flow_and_pretrain_on_flows(tmp_path, port_cli,
                                                     monkeypatch, capsys):
    """`pipeline -mod RGB-Flow --save-flows --flow-jump 2` (bf16, the
    default: the fused ViT path, K1's plain version on the CPU) writes both
    stores, the rendered flows and the CSV; `pretrain --source flows -bs 8
    -e 1 --out-dim 512 --local-crops 2` then trains on those images (a
    patch-32 depth-1 ViT in place of ViT-S/16); with no flow dirs it
    exits."""
    from sais_tpu_torch.io.feature_store import (flow_store_path,
                                                 rgb_store_path)
    from sais_tpu_torch.models import zoo
    os.makedirs(tmp_path / "videos")
    _synth_video(str(tmp_path / "videos" / "vid.mp4"), nframes=24)
    cfg = tiny_cfg(tconfig, dtype="bfloat16")
    monkeypatch.setattr(port_cli, "PipelineConfig", lambda: cfg)
    port_cli.main(["pipeline", "-f", "vid", "-p", str(tmp_path), "-mod",
                   "RGB-Flow", "--random-init", "--device", "cpu",
                   "--save-flows", "--flow-jump", "2", "--flow-iters", "2"])
    out = capsys.readouterr().out
    assert "extracted (24, 48)" in out and "flow reps (11, 48)" in out
    assert (tmp_path / "results" / "Custom_inference_gestures.csv").exists()
    flows, attrs = _read_store(flow_store_path(str(tmp_path)))
    assert attrs == {"flow_jump": 2} and np.isfinite(flows).all()
    assert _read_store(rgb_store_path(str(tmp_path)))[0].shape == (24, DIM)
    assert sorted(os.listdir(tmp_path / "flows" / "vid")) == [
        f"flows_{i:08d}.jpg" for i in range(11)]

    monkeypatch.setitem(zoo.CONFIGS, "vits16", tconfig.ViTConfig(
        image_size=224, patch_size=32, embed_dim=64, depth=1, num_heads=1))
    pre = ["pretrain", "-p", str(tmp_path), "--source", "flows", "-bs", "8",
           "-e", "1", "--out-dim", "512", "--local-crops", "2", "--device",
           "cpu", "--loader-threads", "2"]
    port_cli.main(pre)
    assert "epoch 0: loss" in capsys.readouterr().out
    assert os.listdir(tmp_path / "pretrain" / "ckpt") == ["1.pt"]
    empty = tmp_path / "empty"
    os.makedirs(empty / "flows")
    with pytest.raises(SystemExit, match="no flow dirs"):
        port_cli.main([*pre[:1], "-p", str(empty), *pre[3:]])


def test_cli_random_raft_needs_random_init(tmp_path, port_cli):
    os.makedirs(tmp_path / "videos")
    _synth_video(str(tmp_path / "videos" / "vid.mp4"), nframes=4)
    with pytest.raises(SystemExit, match="raft-weights or --random-init"):
        port_cli.main(["flow", "-f", "vid", "-p", str(tmp_path),
                       "--device", "cpu",
                       "--dino-weights", str(tmp_path / "none.pth")])
