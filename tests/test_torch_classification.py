"""The port's MIL and ClassificationHead tasks and the other `train`
branches on stored reps against the JAX package on the CPU.

Model pieces (`gated_attention_pool`, `mil_head`, `clip_reps`,
`mil_forward`, `classification_forward` on a tree with a cls_head, the
`self_attention=False` branch) take the same weights through
`full_model_params_from_jax` and are held to 1e-4; the losses,
`logits_metrics` and `make_weighted_loss` likewise.  Two epochs of
`ClassificationTrainer` (MIL) run beside JAX's, dense and with flash
attention (the JAX Pallas kernels in interpret mode, the port's K2 / K3
plain versions), and K2 / K3's plain versions are held to the Pallas
kernels at head widths 32, 80 and 192.  Then both CLIs run in process
(`PipelineConfig` patched to a tiny temporal model in both, the port's
initializers patched to JAX's draws): `train -t MIL`, `-mod Flow` and
`RGB-Flow`, `--dataset vua-gestures` and `dvc-ucl`, each split policy,
`--no-self-attention` and `-dim` give the same epoch losses and saved
parameters within 1e-4, and `-t ClassificationHead` on reps and MIL with
more than 3 classes raise in both.  A fold in the port's earlier layout
(no clip or MIL members) still decodes."""

import csv
import dataclasses
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sais_tpu import config as jconfig
from sais_tpu.cli.main import main as jax_main
from sais_tpu.kernels import flash_attention as jfa
from sais_tpu.models import full_model as jfm
from sais_tpu.models import heads as jheads
from sais_tpu.train import classification as jcls
from sais_tpu.train import loop as jloop
from sais_tpu.train import losses as jlosses
from sais_tpu.train import metrics as jmetrics
from sais_tpu_torch import config as tconfig
from sais_tpu_torch.cli import main as cli
from sais_tpu_torch.io.feature_store import (FeatureStore, flow_store_path,
                                             rgb_store_path)
from sais_tpu_torch.kernels.flash_attention import flash_attention
from sais_tpu_torch.models import full_model as tfm
from sais_tpu_torch.models import heads
from sais_tpu_torch.port.weights import (full_model_params_from_jax,
                                         full_model_params_to_jax)
from sais_tpu_torch.train import classification as tcls
from sais_tpu_torch.train import loop as tloop
from sais_tpu_torch.train import losses, metrics

DIM = 32
TEMP = dict(rep_dim=DIM, num_layers=2, num_heads=4, ffn_dim=64,
            max_positions=64)


def _cfgs(**kw):
    """(JAX ModelConfig, port ModelConfig) with the same fields."""
    temporal = dict(TEMP, use_flash=kw.pop("use_flash", None))
    base = dict(dict(rep_dim=DIM, modalities="RGB"), **kw)
    return (jconfig.ModelConfig(**base,
                                temporal=jconfig.TemporalConfig(**temporal)),
            tconfig.ModelConfig(**base,
                                temporal=tconfig.TemporalConfig(**temporal)))


def _pair(seed=0, **kw):
    """(JAX params, port FullModel with the same weights, jcfg, cfg)."""
    jcfg, cfg = _cfgs(**kw)
    params = jfm.full_model_init(jax.random.key(seed), jcfg)
    model = tfm.FullModel(cfg)
    model.load_state_dict(full_model_params_from_jax(
        jax.tree.map(np.asarray, params)))
    return params, model, jcfg, cfg


def _rgb(seed, b=3, s=2, f=6, d=DIM):
    """Features and a ragged mask (element i keeps f - i frames)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, f, d)).astype(np.float32)
    mask = np.zeros((b, s, f + 1), bool)
    for i in range(b):
        mask[i, :, f + 1 - i:] = True
    return x, mask


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(np.asarray(got.detach() if
                                          isinstance(got, torch.Tensor)
                                          else got), np.asarray(want),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# The model: members, MIL head, clip encoder, classification head, -sa off
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, dict(importance_head=True,
                                         multi_task=True, data_type="raw")])
def test_full_model_carries_every_member_of_the_jax_tree(kw):
    """The port's FullModel takes every leaf of JAX's tree (strict load),
    and full_model_params_to_jax gives the tree back, leaf for leaf."""
    params, model, _, _ = _pair(1, **kw)
    tree = full_model_params_to_jax(model.state_dict())
    want = jax.tree.map(np.asarray, params)
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    assert (model.cls_head is None) == ("data_type" not in kw)


def test_prototypes_path_draws_come_first():
    """full_model_init draws the Prototypes path's members in the order
    they were drawn before the clip and MIL members existed, so a seed
    gives that path the same weights; the new members come after."""
    _, cfg = _cfgs(importance_head=True)
    model = tfm.full_model_init(torch.Generator().manual_seed(7), cfg)
    g = torch.Generator().manual_seed(7)
    want = {"frame_cls": torch.rand(DIM, generator=g),
            "frame_pos": torch.rand((TEMP["max_positions"], DIM),
                                    generator=g)}
    for name, fi, fo in (("linear", DIM, 256), ("linear2", 256, 3)):
        lim = (1.0 / fi) ** 0.5
        want[name + ".weight"] = (torch.rand((fo, fi), generator=g) * 2
                                  - 1) * lim
        want[name + ".bias"] = (torch.rand(fo, generator=g) * 2 - 1) * lim
    enc = tfm.TransformerEncoder(cfg.temporal)
    tfm.encoder_init(enc, g, cfg.temporal)
    want.update({"frame_encoder." + k: v
                 for k, v in enc.state_dict().items()})
    lim = (1.0 / DIM) ** 0.5
    want["importance.weight"] = (torch.rand((1, DIM), generator=g) * 2
                                 - 1) * lim
    want["importance.bias"] = (torch.rand(1, generator=g) * 2 - 1) * lim
    sd = model.state_dict()
    for name, value in want.items():
        torch.testing.assert_close(sd[name], value, rtol=0, atol=0)
    assert torch.equal(model.clip_cls, torch.rand(DIM, generator=g))


def test_mil_head_and_gated_pool_match_jax():
    params, model, _, _ = _pair(2)
    x = np.random.default_rng(3).standard_normal((4, 5, DIM)).astype(
        np.float32)
    for c in ("0", "1", "2"):
        jrep, jattn = jheads.gated_attention_pool(jnp.asarray(x), params, c)
        rep, attn = heads.gated_attention_pool(torch.tensor(x), model, c)
        _close(rep, jrep)
        _close(attn, jattn)
    jlogits, jatt = jheads.mil_head(jnp.asarray(x), params, 3)
    logits, att = heads.mil_head(torch.tensor(x), model, 3)
    assert logits.shape == (4, 3) and set(att) == set(jatt) == {0, 1, 2}
    _close(logits, jlogits)
    for c in att:
        _close(att[c], jatt[c])
    for fn, tree in ((jheads.mil_head, params), (heads.mil_head, model)):
        with pytest.raises(ValueError, match="n_attention_classes"):
            fn(jnp.asarray(x) if tree is params else torch.tensor(x), tree,
               4)


def test_clip_reps_and_mil_forward_match_jax():
    params, model, jcfg, cfg = _pair(4, nclasses=3)
    s = np.random.default_rng(5).standard_normal((3, 4, DIM)).astype(
        np.float32)
    _close(tfm.clip_reps(model, torch.tensor(s), cfg),
           jfm.clip_reps(params, jnp.asarray(s), jcfg))
    x, mask = _rgb(6, s=3)
    jlogits, jatt = jfm.mil_forward(params, jcfg, jnp.asarray(x),
                                    jnp.asarray(mask))
    logits, att = tfm.mil_forward(model, cfg, torch.tensor(x),
                                  torch.tensor(mask))
    _close(logits, jlogits)
    for c in jatt:
        _close(att[c], jatt[c])


@pytest.mark.parametrize("modalities", ["RGB", "Flow", "RGB-Flow"])
def test_classification_forward_matches_jax(modalities):
    """On a tree with a cls_head (data_type 'raw', as the raw slice will
    use it); without one both packages raise KeyError."""
    params, model, jcfg, cfg = _pair(7, nclasses=3, data_type="raw",
                                     modalities=modalities)
    rgb, rmask = _rgb(8)
    flow, fmask = _rgb(9, f=3)
    args = (rgb, rmask, flow, fmask)
    want = jfm.classification_forward(params, jcfg,
                                      *[jnp.asarray(a) for a in args])
    got = tfm.classification_forward(model, cfg,
                                     *[torch.tensor(a) for a in args])
    assert got.shape == want.shape == ((3, 3) if modalities == "RGB-Flow"
                                       else (3, 2, 3))
    _close(got, want)
    params, model, jcfg, cfg = _pair(7, nclasses=3, modalities=modalities)
    with pytest.raises(KeyError, match="cls_head"):
        jfm.classification_forward(params, jcfg,
                                   *[jnp.asarray(a) for a in args])
    with pytest.raises(KeyError, match="cls_head"):
        tfm.classification_forward(model, cfg,
                                   *[torch.tensor(a) for a in args])


def test_no_self_attention_matches_jax():
    """Without -sa the snippet track is the plain frame mean (pad rows
    included), attention the ones((1, 1)) placeholder, no importance."""
    params, model, jcfg, cfg = _pair(10, modalities="RGB-Flow",
                                     self_attention=False,
                                     importance_head=True)
    rgb, rmask = _rgb(11)
    flow, fmask = _rgb(12, f=4)
    t = tfm.temporal_features(model, torch.tensor(rgb), torch.tensor(rmask),
                              cfg)
    assert t.full_seq is None and torch.equal(t.attn, torch.ones((1, 1)))
    _close(t.cls_seq, rgb.mean(axis=2), 1e-6)
    args = (rgb, rmask, flow, fmask)
    want = jfm.prototypes_forward(params, jcfg,
                                  *[jnp.asarray(a) for a in args])
    got = tfm.prototypes_forward(model, cfg,
                                 *[torch.tensor(a) for a in args])
    _close(got.video_rep, want.video_rep)
    _close(got.aux_logits, want.aux_logits)
    assert got.importances is None and want.importances is None


# ---------------------------------------------------------------------------
# Losses and metrics
# ---------------------------------------------------------------------------

def test_losses_match_jax():
    rng = np.random.default_rng(13)
    logits = rng.standard_normal((6, 4)).astype(np.float32) * 3
    flipped = rng.standard_normal((5, 4)).astype(np.float32) * 3
    labels = np.array([0, 3, 1, 2, 2, 0], np.int32)
    one = rng.standard_normal((6, 1)).astype(np.float32) * 4
    future = rng.standard_normal((2, 5, 8)).astype(np.float32)
    snips = rng.standard_normal((2, 5, 8)).astype(np.float32)
    t, j = torch.tensor, jnp.asarray
    pairs = [
        (losses.cross_entropy(t(logits), t(labels)),
         jlosses.cross_entropy(j(logits), j(labels))),
        (losses.binary_cross_entropy_logits(t(one), t(labels % 2)),
         jlosses.binary_cross_entropy_logits(j(one), j(labels % 2))),
        (losses.next_rep_mse(t(future), t(snips)),
         jlosses.next_rep_mse(j(future), j(snips))),
        (losses.temporal_coherence_loss(t(logits), t(flipped)),
         jlosses.temporal_coherence_loss(j(logits), j(flipped))),
        (losses.temporal_coherence_accuracy(t(logits), t(flipped)),
         jlosses.temporal_coherence_accuracy(j(logits), j(flipped)))]
    for got, want in pairs:
        assert abs(float(got) - float(want)) <= 1e-6 * max(1, abs(float(
            want))), (float(got), float(want))


@pytest.mark.parametrize("nclasses", [1, 3])
def test_make_weighted_loss_matches_jax(nclasses):
    """CE (BCE for one class) with and without the 0 / 1 row weight: loss
    and logits within 1e-6 of JAX's, and a zero-weight row gets no
    gradient."""
    rng = np.random.default_rng(nclasses)
    w = rng.standard_normal((DIM, max(nclasses, 1))).astype(np.float32)
    x = rng.standard_normal((5, DIM)).astype(np.float32)
    labels = rng.integers(0, max(nclasses, 2), 5).astype(np.int32)
    weight = np.array([1, 1, 0, 1, 0], np.float32)
    jloss = jcls.make_weighted_loss(lambda p, b: b["x"] @ p, nclasses)
    tloss = tcls.make_weighted_loss(lambda m, b: b["x"] @ m, nclasses)
    for extra in ({}, {"weight": weight}):
        jb = {"x": jnp.asarray(x), "labels": jnp.asarray(labels),
              **{k: jnp.asarray(v) for k, v in extra.items()}}
        tx = torch.tensor(x, requires_grad=True)
        tb = {"x": tx, "labels": torch.tensor(labels),
              **{k: torch.tensor(v) for k, v in extra.items()}}
        (jl, jlg), (tl, tlg) = jloss(jnp.asarray(w), jb), tloss(
            torch.tensor(w), tb)
        assert abs(float(tl) - float(jl)) <= 1e-6
        _close(tlg, jlg, 1e-6)
        tl.backward()
        if extra:
            assert not tx.grad[weight == 0].any()


def test_logits_metrics_match_sklearn_fuzz():
    """logits_metrics (TTA logit mean, sigmoid or softmax) against the JAX
    package's sklearn metrics: 150 random draws of 1-4 classes with
    single-class label sets among them.  Limit 1e-9."""
    rng = np.random.default_rng(17)
    for case in range(150):
        n = int(rng.integers(1, 5))
        b = int(rng.integers(1, 12))
        labels = rng.integers(0, max(n, 2), b)
        if case % 5 == 0:
            labels[:] = labels[0]
        tta = list(rng.standard_normal((int(rng.choice([1, 3])), b, n))
                   .round(1))
        want = jmetrics.logits_metrics(tta, labels, n)
        got = metrics.logits_metrics(tta, labels, n)
        assert got.keys() == want.keys()
        for k in want:
            if np.isnan(want[k]):
                assert np.isnan(got[k]), (case, k)
            else:
                assert abs(got[k] - want[k]) <= 1e-9, (case, k)


# ---------------------------------------------------------------------------
# Collation with flow rows
# ---------------------------------------------------------------------------

class _Store:
    def __init__(self, videos):
        self.videos = videos

    def read_video(self, name):
        return self.videos[name]


@pytest.mark.parametrize("use_flow, flow_rows", [(True, 20), (True, 9),
                                                  (False, 20)])
def test_segment_batches_with_flow_match_jax(use_flow, flow_rows):
    """segment_batches over an RGB and a flow store (flow rows past the
    store's length dropped, flow buckets 2-16; with a 9-row flow store
    most segments have no flow row left: one zero slot, masked), with the
    TTA variants: the same arrays, key for key, as the JAX package's.  A
    segment's flow key mask is a suffix after the CLS slot: its flow rows
    are sorted, so those past the store's length end the window."""
    import pandas as pd

    from sais_tpu import config as jcfgmod
    from sais_tpu.data import collate as jcollate
    from sais_tpu_torch.data import collate
    rng = np.random.default_rng(31)
    rgb = _Store({f"v{i}": rng.standard_normal((400, 8)).astype(np.float32)
                  for i in range(3)})
    flow = _Store({f"v{i}": rng.standard_normal((flow_rows, 8)).astype(
        np.float32) for i in range(3)})
    rows = []
    for i in range(10):
        start = int(rng.integers(1, 330))
        rows.append({"Video": f"v{i % 3}", "StartFrame": start,
                     "EndFrame": start + int(rng.integers(12, 70)),
                     "Gesture": "AB"[i % 2]})
    want = list(jcollate.segment_batches(
        pd.DataFrame(rows), rgb, flow, ["A", "B"], jcfgmod.WindowConfig(), 4,
        True, seed=2, tta=True, use_flow=use_flow))
    got = list(collate.segment_batches(
        rows, rgb, ["A", "B"], tconfig.WindowConfig(), 4, True, seed=2,
        tta=True, flow_store=flow if use_flow else None))
    assert len(got) == len(want) == 3
    no_flow = 0
    for g, w in zip(got, want):
        for gv, wv in zip([g] + g["tta"], [w] + w["tta"]):
            assert set(gv) - {"tta"} == set(wv) - {"tta"}
            assert ("flow" in gv) == use_flow
            for key in set(wv) - {"tta"}:
                np.testing.assert_array_equal(gv[key], wv[key], key)
                assert gv[key].dtype == wv[key].dtype, key
            if use_flow:
                m = gv["flow_mask"][:, 0]
                assert not m[:, 0].any()
                assert not (m[:, :-1] & ~m[:, 1:]).any()
                no_flow += int(m[:, 1:].all(1).sum())
    assert (no_flow > 0) == (use_flow and flow_rows < 20)


# ---------------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------------

def _batches(n, b=4, s=2, f=6, seed=0, tta=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        labels = rng.integers(0, 2, b).astype(np.int32)
        variants = []
        for _ in range(3 if tta else 1):
            x, mask = _rgb(int(rng.integers(1 << 30)), b, s, f)
            x += np.where(labels == 0, 0.5, -0.5)[:, None, None, None]
            variants.append({"rgb": x.astype(np.float32), "rgb_mask": mask,
                             "label_cols": labels, "labels": labels})
        batch = dict(variants[0])
        if tta:
            batch["tta"] = variants
        out.append(batch)
    return out


@pytest.mark.parametrize("use_flash", [False, True])
def test_classification_trainer_matches_jax(use_flash):
    """Two MIL epochs (two train batches, one val batch with TTA) from the
    same weights: epoch losses and metrics, and every parameter after,
    within 1e-4 of JAX's trainer (f32 on both sides, summation order);
    with flash attention the JAX Pallas kernels run in interpret mode,
    the port's K2 / K3 plain versions."""
    params, model, jcfg, cfg = _pair(20, use_flash=use_flash)
    jtr = jcls.ClassificationTrainer(jcfg, jconfig.TrainConfig(lr=0.2),
                                     params, task="MIL")
    tr = tcls.ClassificationTrainer(cfg, tconfig.TrainConfig(lr=0.2), model,
                                    task="MIL", device="cpu")
    train, val = _batches(2, seed=1), _batches(1, seed=2, tta=True)
    for _ in range(2):
        for batches, is_train in ((train, True), (val, False)):
            jl, jm = jtr.run_epoch(iter(batches), is_train)
            gl, gm = tr.run_epoch(iter(batches), is_train)
            assert abs(gl - jl) <= 1e-4
            assert gm.keys() == jm.keys()
            for k in ("acc", "precision", "recall"):
                assert gm[k] == pytest.approx(jm[k], abs=1e-6)
    want = full_model_params_from_jax(jax.tree.map(np.asarray, jtr.params))
    for name, p in tr.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0,
                                   atol=1e-4, err_msg=name)
    with pytest.raises(NotImplementedError, match="Parallelism"):
        tcls.ClassificationTrainer(cfg, tconfig.TrainConfig(), model,
                                   mesh=object(), device="cpu")


def test_sgd_leaves_members_without_gradient_alone():
    """A Prototypes step reaches neither the clip encoder nor the MIL
    modules: torch's SGD skips them (no gradient), optax adds a zero
    update; both leave them as they were."""
    _, model, _, cfg = _pair(21)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tr = tloop.PrototypeTrainer(cfg, tconfig.TrainConfig(lr=0.5), model,
                                ["0", "1"], torch.rand(2, 256),
                                device="cpu")
    tr.run_epoch(iter(_batches(1, seed=3)), train=True)
    untouched = [n for n, p in tr.model.named_parameters() if p.grad is None]
    assert {n.split(".")[0] for n in untouched} == {
        "clip_cls", "clip_pos", "clip_encoder", "attentionA", "attentionB",
        "attention_modules", "final_modules", "linear2"}
    for n in untouched:
        assert torch.equal(tr.model.state_dict()[n], before[n]), n


@pytest.mark.parametrize("dh", [32, 80, 192])
def test_flash_plain_versions_match_pallas_at_head_widths(dh):
    """K2's and K3's plain versions against the Pallas kernels (interpret
    mode; JAX pads the width to 128 lanes) at the head widths of -dim 128,
    320 and 768 over 4 heads, masked tails and an all-masked element:
    out within 2e-5, gradients within 2e-4 (the existing limits)."""
    b, h, l = 3, 4, 21
    rng = np.random.default_rng(dh)
    q, k, v, cot = (rng.standard_normal((b, h, l, dh)).astype(np.float32)
                    for _ in range(4))
    mask = np.zeros((b, l), bool)
    mask[0, l - 5:] = True
    mask[2] = True

    def loss(q, k, v):
        out = jfa.flash_attention(q, k, v, jnp.asarray(mask), interpret=True)
        return jnp.sum(out * cot), out

    (_, jout), jgrads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = flash_attention(tq, tk, tv, torch.tensor(mask))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=2e-5, atol=2e-5)
    out.backward(torch.tensor(cot))
    for name, g, r in zip("qkv", (tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-4,
                                   atol=2e-4, err_msg=name)


def test_fold_without_clip_members_still_decodes(tmp_path):
    """A params.pkl in the layout the port wrote before it carried the
    clip encoder and MIL modules loads (those members zero) and decodes
    to the same window probabilities as the model that wrote it."""
    from sais_tpu_torch.infer.pipeline import GestureDecoder
    _, model, _, cfg = _pair(22)
    tree = full_model_params_to_jax(model.state_dict())
    old = {k: tree[k] for k in ("frame_cls", "frame_pos", "frame_encoder",
                                "linear", "linear2")}
    (tmp_path / "Fold_0").mkdir()
    for name, obj in (("params", old),
                      ("prototypes", np.random.default_rng(0).random(
                          (2, 256)).astype(np.float32))):
        with open(tmp_path / "Fold_0" / f"{name}.pkl", "wb") as f:
            pickle.dump(obj, f)
    pcfg = tconfig.PipelineConfig(model=cfg)
    loaded, protos = cli.load_fold(str(tmp_path / "Fold_0"), pcfg)
    assert not loaded.clip_pos.any() and not loaded.attentionA.weight.any()
    feats = np.random.default_rng(1).standard_normal((120, DIM)).astype(
        np.float32)
    got = GestureDecoder([(loaded, protos)], pcfg, device="cpu"
                         ).window_probs("v", feats)
    want = GestureDecoder([(model, protos)], pcfg, device="cpu"
                          ).window_probs("v", feats)
    np.testing.assert_array_equal(got, want)
    bad = dict(old, extra={"w": np.zeros((1, 1), np.float32)})
    with open(tmp_path / "Fold_0" / "params.pkl", "wb") as f:
        pickle.dump({k: v for k, v in bad.items() if k != "linear2"}, f)
    with pytest.raises(RuntimeError, match="linear2"):
        cli.load_fold(str(tmp_path / "Fold_0"), pcfg)


# ---------------------------------------------------------------------------
# The CLI: both packages in process
# ---------------------------------------------------------------------------

NFRAMES = 600
VIDEOS = [f"vid{v}" for v in range(8)]


def _tiny_pipeline(cfgmod):
    cfg = cfgmod.PipelineConfig(model=cfgmod.ModelConfig(
        rep_dim=DIM, temporal=cfgmod.TemporalConfig(**TEMP)))
    return lambda: cfg


def _write_csv(path, rows):
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)


def _write_root(root, dim):
    rng = np.random.default_rng(dim)
    for path, n in ((rgb_store_path(str(root)), NFRAMES),
                    (flow_store_path(str(root)), NFRAMES // 15 - 4)):
        with FeatureStore(path, "a") as fs:
            for v in VIDEOS:
                fs.write_video(v, rng.standard_normal((n, dim)).astype(
                    np.float32))
    segs, gestures = [], []
    for i, v in enumerate(VIDEOS):
        for j in range(8):
            start = int(rng.integers(1, NFRAMES - 70))
            span = int(rng.integers(12, 60))
            segs.append({"Video": v, "StartFrame": start,
                         "EndFrame": start + span,
                         "Gesture": "AB"[(i + j) % 2],
                         "Subject": f"U{i % 4}"})
            sep = "\\" if i % 2 else "/"
            gestures.append({
                "Path": sep.join(["data", "site", v]), "StartFrame": start,
                "EndFrame": start + span,
                "Gesture": ["1", "2", " 1", "7", "13", "1,2", "", "0", "3",
                            "4", "6", "2"][(3 * i + j) % 12]})
    _write_csv(root / "segs.csv", segs)
    _write_csv(root / "gestures.csv", gestures)
    return root


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """Stores of 32-wide features (and 48-wide ones for -dim 48), RGB and
    flow (40 flow rows a video: the windows' late flow slots fall past
    the store and are masked), with a segments table (two classes, four
    subjects) and a gesture-timestamp table (Path with either separator,
    multi-label and empty cells)."""
    return {d: _write_root(tmp_path_factory.mktemp(f"cls{d}"), d)
            for d in (DIM, 48)}


def _jax_model_cfg(cfg):
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(cfg) if f.name != "temporal"}
    return jconfig.ModelConfig(**fields, temporal=jconfig.TemporalConfig(
        **dataclasses.asdict(cfg.temporal)))


@pytest.fixture
def patched(monkeypatch):
    """Both CLIs on the tiny temporal model; the port's initializers draw
    JAX's weights for the fold (its seeds are 2k and 2k + 1); every
    run_epoch's (train, loss) recorded per package."""
    monkeypatch.setattr(jconfig, "PipelineConfig", _tiny_pipeline(jconfig))
    monkeypatch.setattr(cli, "PipelineConfig", _tiny_pipeline(tconfig))

    def init(generator, cfg):
        fold = generator.initial_seed() // 2
        tree = jfm.full_model_init(
            jax.random.fold_in(jax.random.key(0), fold), _jax_model_cfg(cfg))
        model = tfm.FullModel(cfg)
        model.load_state_dict(full_model_params_from_jax(
            jax.tree.map(np.asarray, tree)))
        return model

    def protos_init(generator, nclasses, proj_dim=256):
        fold = generator.initial_seed() // 2
        keys, mat = jfm.prototypes_init(
            jax.random.fold_in(jax.random.key(1), fold), nclasses, proj_dim)
        return keys, torch.tensor(np.asarray(mat))

    monkeypatch.setattr(tfm, "full_model_init", init)
    monkeypatch.setattr(tfm, "prototypes_init", protos_init)
    record = {"jax": [], "port": []}
    for name, classes in (("jax", (jloop.PrototypeTrainer,
                                   jcls.ClassificationTrainer)),
                          ("port", (tloop.PrototypeTrainer,
                                    tcls.ClassificationTrainer))):
        for klass in classes:
            def run(self, batches, train, _orig=klass.run_epoch,
                    _out=record[name]):
                loss, m = _orig(self, batches, train)
                _out.append((train, loss))
                return loss, m
            monkeypatch.setattr(klass, "run_epoch", run)
    return record


def _params(root):
    with open(root / "params" / "Fold_0" / "params.pkl", "rb") as f:
        return full_model_params_from_jax(pickle.load(f))


CLI_CASES = {
    "mil": ["-t", "MIL", "-bc"],
    "mil-flash": ["-t", "MIL", "--flash", "on"],
    "flow": ["-mod", "Flow", "-bc"],
    "rgb-flow": ["-mod", "RGB-Flow"],
    "vua-gestures": ["--dataset", "vua-gestures", "-d", "1_vs_2", "-bc"],
    "vua-gestures-mil": ["--dataset", "vua-gestures", "-d", "1_vs_2", "-t",
                         "MIL", "-mod", "RGB-Flow"],
    "dvc-ucl": ["--dataset", "dvc-ucl"],
    "per-gesture-video": ["--split-policy", "per-gesture-video", "-bc"],
    "louo": ["--split-policy", "louo"],
    "instance": ["--split-policy", "instance", "-bc"],
    "no-self-attention": ["--no-self-attention", "-bc", "-mod", "RGB-Flow"],
    "dim": ["-dim", "48", "-t", "MIL"],
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_train_matches_jax(roots, patched, case, capsys):
    """`train ... -e 2 -bs 4 --nfolds 1` by both CLIs on one store: the
    same sequence of epochs (train / val / test) with losses within 1e-4,
    and the saved params.pkl within 1e-4, leaf for leaf."""
    flags = CLI_CASES[case]
    root = roots[48 if "-dim" in flags else DIM]
    table = "gestures.csv" if "--dataset" in flags else "segs.csv"
    args = ["train", "-p", str(root), "--segments", str(root / table),
            "-e", "2", "-bs", "4", "-lr", "0.3", *flags]
    jax_main(args)
    want = _params(root)
    cli.main([*args, "--device", "cpu"])
    got = _params(root)
    assert "saved fold 0" in capsys.readouterr().out
    jrec, trec = patched["jax"], patched["port"]
    assert [t for t, _ in trec] == [t for t, _ in jrec] and len(jrec) >= 4
    np.testing.assert_allclose([l for _, l in trec], [l for _, l in jrec],
                               rtol=0, atol=1e-4)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("flags,error", [
    (["-t", "ClassificationHead"], KeyError),
    (["--dataset", "vua-gestures", "-t", "MIL"], ValueError),
    (["--dataset", "dvc-ucl", "-t", "MIL"], ValueError)])
def test_cli_train_raises_as_jax(roots, patched, flags, error):
    """-t ClassificationHead on reps (no cls_head: JAX's KeyError at the
    first step) and MIL over Top4's 4 or dvc-ucl's 7 classes (more than
    the 3 per-class modules) raise in both CLIs."""
    root = roots[DIM]
    table = "gestures.csv" if "--dataset" in flags else "segs.csv"
    args = ["train", "-p", str(root), "--segments", str(root / table),
            "-e", "1", "-bs", "4", *flags]
    for run in (jax_main, lambda a: cli.main([*a, "--device", "cpu"])):
        with pytest.raises(error, match="cls_head|n_attention_classes"):
            run(args)
