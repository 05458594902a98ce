"""DINO pre-training in the port against the JAX package: the head, the
loss and center, schedules, clipping, last-layer cancel, EMA, the three
optimizers against optax, the augmentation's apply halves fed JAX's
draws, DINOTrainer steps from the same weights, checkpoint resume, the
`pretrain` command end to end on the CPU and the refusals.

Numpy-seeded inputs go to both sides.  Limits are stated beside each
check: f32 parity 1e-5 to 1e-6 (summation order only); the bf16 trainer
(JAX's XLA bf16 path against the port's) 2e-3 relative on losses, 1e-3 of
the largest value on the center and on sgd-updated parameters, and 2 lr a
step on adamw-updated parameters, whose first steps are sign-like.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from sais_tpu.models import dino_head as jhead
from sais_tpu.ops import augment as jaug
from sais_tpu.train import dino as jdino
from sais_tpu_torch.config import ViTConfig
from sais_tpu_torch.models import dino_head as thead
from sais_tpu_torch.ops import augment as taug
from sais_tpu_torch.port.weights import (dino_head_params_from_jax,
                                         dino_state_from_jax)
from sais_tpu_torch.train import dino as tdino


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _head_pair(in_dim=48, out_dim=96, hidden=64, bottleneck=32):
    params = jhead.dino_head_init(jax.random.key(0), in_dim, out_dim,
                                  hidden=hidden, bottleneck=bottleneck)
    params = jax.tree.map(
        lambda a: a + 0.02 * jax.random.normal(jax.random.key(1), a.shape),
        params)
    head = thead.DINOHead(in_dim, out_dim, hidden, bottleneck)
    head.load_state_dict(dino_head_params_from_jax(
        jax.tree.map(np.asarray, params)))
    return params, head


@pytest.mark.parametrize("norm_last_layer", [True, False])
def test_head_matches_jax(norm_last_layer):
    """f32 within 1e-5 of the largest logit; bf16 (bf16 MLP products, f32
    normalization and last-layer accumulation) within 2e-2."""
    params, head = _head_pair()
    x = np.random.default_rng(0).standard_normal((10, 48)).astype(np.float32)
    ref = _np(jhead.dino_head_forward(params, jnp.asarray(x),
                                      norm_last_layer))
    got = _np(thead.dino_head_forward(head, _t(x), norm_last_layer))
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    ref = _np(jhead.dino_head_forward(
        params, jnp.asarray(x).astype(jnp.bfloat16), norm_last_layer))
    got = thead.dino_head_forward(head, _t(x).bfloat16(), norm_last_layer)
    assert got.dtype == torch.float32
    assert np.abs(_np(got) - ref).max() <= 2e-2 * np.abs(ref).max()
    np.testing.assert_allclose(
        _np(thead.dino_head_bottleneck(head, _t(x))),
        _np(jhead.dino_head_bottleneck(params, jnp.asarray(x))),
        rtol=1e-5, atol=1e-6)


def test_head_init_and_bn_refusal():
    head = thead.dino_head_init(torch.Generator().manual_seed(0), 384, 512)
    assert head.last_v.shape == (256, 512) and bool((head.last_g == 1).all())
    assert head.mlp[0].weight.shape == (2048, 384)
    assert abs(head.mlp[1].weight.std().item() - 0.02) < 1e-3
    assert all(bool((lin.bias == 0).all()) for lin in head.mlp)
    assert head.bn is None
    # the BatchNorm head (no longer refused): scales 1, biases 0, the
    # same draws for the linears
    bn_head = thead.dino_head_init(torch.Generator().manual_seed(0), 384,
                                   512, use_bn=True)
    assert torch.equal(bn_head.mlp[1].weight, head.mlp[1].weight)
    assert [tuple(b.scale.shape) for b in bn_head.bn] == [(2048,), (2048,)]
    assert all(bool((b.scale == 1).all() and (b.bias == 0).all())
               for b in bn_head.bn)


def test_loss_and_center_match_jax():
    rng = np.random.default_rng(1)
    s_out = [rng.standard_normal((5, 64)).astype(np.float32) * 3
             for _ in range(6)]
    t_out = [rng.standard_normal((5, 64)).astype(np.float32) * 3
             for _ in range(2)]
    center = rng.standard_normal(64).astype(np.float32) * 0.1
    ref, ref_c = jdino.dino_loss([jnp.asarray(s) for s in s_out],
                                 [jnp.asarray(t) for t in t_out],
                                 jnp.asarray(center), 0.04)
    got, got_c = tdino.dino_loss([_t(s) for s in s_out],
                                 [_t(t) for t in t_out], _t(center), 0.04)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-5)
    np.testing.assert_allclose(_np(got_c), _np(ref_c), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(
        _np(tdino.update_center(_t(center), got_c, 0.9)),
        _np(jdino.update_center(jnp.asarray(center), ref_c, 0.9)),
        rtol=1e-6, atol=1e-7)


def test_schedules_match_jax():
    cfg = jdino.DINOConfig(warmup_teacher_temp=0.04, teacher_temp=0.07,
                           warmup_teacher_temp_epochs=3)
    tcfg = tdino.DINOConfig(warmup_teacher_temp=0.04, teacher_temp=0.07,
                            warmup_teacher_temp_epochs=3)
    for args in ((5e-4, 1e-6, 10, 7, 2), (0.04, 0.4, 10, 7, 0),
                 (0.996, 1.0, 3, 1, 0)):
        np.testing.assert_array_equal(tdino.cosine_scheduler(*args),
                                      jdino.cosine_scheduler(*args))
    np.testing.assert_array_equal(tdino.teacher_temp_schedule(tcfg, 8),
                                  jdino.teacher_temp_schedule(cfg, 8))
    with pytest.raises(ValueError, match="warmup"):
        tdino.cosine_scheduler(1.0, 0.0, 2, 3, warmup_epochs=3)


def _grad_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((6, 5)).astype(np.float32) * 4,
            "b": rng.standard_normal(5).astype(np.float32) * 0.1,
            "z": np.zeros(3, np.float32)}


def test_clip_cancel_ema_match_jax():
    g = _grad_tree(2)
    ref = jdino.clip_gradients_per_param(jax.tree.map(jnp.asarray, g), 3.0)
    got = tdino.clip_gradients_per_param({k: _t(v) for k, v in g.items()},
                                         3.0)
    for k in g:
        np.testing.assert_allclose(_np(got[k]), _np(ref[k]), rtol=1e-6,
                                   atol=1e-7)
    grads = {"head.last_v": _t(g["w"]), "head.last_g": _t(g["b"]),
             "backbone.x": _t(g["z"] + 1)}
    for cancel in (True, False):
        out = tdino.cancel_last_layer_grads(grads, cancel)
        ref = jdino.cancel_last_layer_grads(
            {"head": {"last_v": jnp.asarray(g["w"]),
                      "last_g": jnp.asarray(g["b"])}}, jnp.bool_(cancel))
        np.testing.assert_array_equal(_np(out["head.last_v"]),
                                      _np(ref["head"]["last_v"]))
        np.testing.assert_array_equal(_np(out["head.last_g"]),
                                      _np(ref["head"]["last_g"]))
        assert torch.equal(out["backbone.x"], grads["backbone.x"])
    t, s = torch.nn.Linear(5, 6), torch.nn.Linear(5, 6)
    ref = jdino.ema_update({"w": jnp.asarray(_np(t.weight))},
                           {"w": jnp.asarray(_np(s.weight))},
                           jnp.float32(0.99))
    tdino.ema_update(t, s, 0.99)
    np.testing.assert_allclose(_np(t.weight), _np(ref["w"]), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("name,jax_opt", [
    ("adamw", lambda: optax.adamw(1.0, weight_decay=0.0)),
    ("sgd", lambda: optax.sgd(1.0, momentum=0.9)),
    ("lars", lambda: optax.lars(1.0))])
def test_optimizers_match_optax(name, jax_opt):
    """Three updates from the same gradients and parameters; a zero
    gradient and a zero parameter take the trust ratio's special case."""
    params = _grad_tree(3)
    params["z"] = np.zeros(3, np.float32)
    opt = jax_opt()
    jp = jax.tree.map(jnp.asarray, params)
    jstate = opt.init(jp)
    topt = tdino.OPTIMIZERS[name]()
    tp = {k: _t(v) for k, v in params.items()}
    tstate = topt.init(tp)
    for step in range(3):
        g = _grad_tree(10 + step)
        ju, jstate = opt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        tu, tstate = topt.update({k: _t(v) for k, v in g.items()}, tstate,
                                 tp)
        for k in params:
            np.testing.assert_allclose(_np(tu[k]), _np(ju[k]), rtol=1e-6,
                                       atol=1e-6, err_msg=f"{k} {step}")
        jp = jax.tree.map(lambda p, u: p + 0.1 * u, jp, ju)
        tp = {k: tp[k] + 0.1 * tu[k] for k in tp}


# ---------------------------------------------------------------------------
# Augmentation: the apply halves against the JAX helpers
# ---------------------------------------------------------------------------

def _jax_crop_draws(key, spec):
    """The draws `augment_crop(key, img, spec)` makes, replayed from its
    key splits, as one image's CropParams entries."""
    k = jax.random.split(key, 8)
    ka, ks2, kx, ky = jax.random.split(k[0], 4)
    kb, kc, ksat, kh, kp = jax.random.split(k[3], 5)
    u = jax.random.uniform
    return dict(
        area=u(ka, (), minval=spec.scale[0], maxval=spec.scale[1]),
        log_ratio=u(ks2, (), minval=jnp.log(3 / 4), maxval=jnp.log(4 / 3)),
        ux=u(kx, ()), uy=u(ky, ()),
        flip=jax.random.bernoulli(k[1], 0.5),
        jitter=jax.random.bernoulli(k[2], 0.8),
        brightness=u(kb, (), minval=0.6, maxval=1.4),
        contrast=u(kc, (), minval=0.6, maxval=1.4),
        saturation=u(ksat, (), minval=0.8, maxval=1.2),
        hue=u(kh, (), minval=-0.1, maxval=0.1),
        perm=jax.random.randint(kp, (), 0, 24),
        gray=jax.random.bernoulli(k[4], 0.2),
        blur=jax.random.bernoulli(k[5], spec.blur_p),
        sigma=u(k[7], (), minval=0.1, maxval=2.0),
        solarize=jax.random.bernoulli(k[6], spec.solarize_p))


def _params_from(keys, spec):
    draws = jax.vmap(lambda k: _jax_crop_draws(k, spec))(keys)
    out = {}
    for name, vals in draws.items():
        vals = np.array(vals)
        out[name] = torch.from_numpy(
            vals.astype(np.float32) if vals.dtype.kind == "f" else vals)
    out["perm"] = out["perm"].long()
    return taug.CropParams(**out)


@pytest.mark.parametrize("spec", [
    jaug.CropSpec(48, (0.4, 1.0), blur_p=0.1, solarize_p=0.2),
    jaug.CropSpec(32, (0.05, 0.4), blur_p=0.5)])
def test_augment_crop_apply_matches_jax(spec):
    """The whole crop (resized crop, flip, color jitter in its random
    order, grayscale, blur, solarize, normalize) for 16 images, each with
    JAX's own draws: within 1e-4 (f32; gathers, convolutions and the 3x3
    color products sum in another order)."""
    rng = np.random.default_rng(4)
    images = rng.random((16, 90, 120, 3)).astype(np.float32)
    keys = jax.random.split(jax.random.key(5), 16)
    ref = _np(jax.vmap(lambda k, img: jaug.augment_crop(k, img, spec))(
        keys, jnp.asarray(images)))
    params = _params_from(keys, spec)
    assert params.jitter.any() and params.blur.any() and params.flip.any()
    tspec = taug.CropSpec(spec.size, spec.scale, spec.blur_p,
                          spec.solarize_p)
    got = _np(taug.apply_crop(_t(images), params, tspec))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_augment_helpers_match_jax():
    """Each apply half on its own: random_resized_crop (with the box
    prefilter), color_jitter over all 24 op orders, gaussian_blur."""
    rng = np.random.default_rng(6)
    images = rng.random((24, 200, 160, 3)).astype(np.float32)
    keys = jax.random.split(jax.random.key(7), 24)
    p = _params_from(keys, jaug.GLOBAL_1)
    ref = jax.vmap(lambda k, img: jaug._random_resized_crop(
        jax.random.split(k, 8)[0], img, 40, (0.4, 1.0)))(
            keys, jnp.asarray(images))
    got = taug.random_resized_crop(_t(images), p.area, p.log_ratio, p.ux,
                                   p.uy, 40, (0.4, 1.0))
    np.testing.assert_allclose(_np(got), _np(ref), rtol=0, atol=1e-5)
    x = _np(got)
    # jitter keys whose op order is permutation i, for i = 0..23
    cands = jax.random.split(jax.random.key(8), 4096)
    perms = np.asarray(jax.vmap(lambda k: jax.random.randint(
        jax.random.split(k, 5)[4], (), 0, 24))(cands))
    jkeys = cands[np.array([np.flatnonzero(perms == i)[0]
                            for i in range(24)])]
    ref = jax.vmap(jaug._color_jitter)(jkeys, jnp.asarray(x))

    def draw(k):
        kb, kc, ks, kh, _ = jax.random.split(k, 5)
        u = jax.random.uniform
        return (u(kb, (), minval=0.6, maxval=1.4),
                u(kc, (), minval=0.6, maxval=1.4),
                u(ks, (), minval=0.8, maxval=1.2),
                u(kh, (), minval=-0.1, maxval=0.1))

    factors = [_t(np.asarray(f)) for f in jax.vmap(draw)(jkeys)]
    got = taug.color_jitter(_t(x), *factors, torch.arange(24))
    np.testing.assert_allclose(_np(got), _np(ref), rtol=0, atol=1e-5)
    ref = jax.vmap(lambda k, img: jaug._gaussian_blur(
        jax.random.split(k, 8)[7], img, 40))(keys, jnp.asarray(x))
    got = taug.gaussian_blur(_t(x), p.sigma)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=0, atol=1e-5)


def test_multi_crop_batch_layout_and_ranges(monkeypatch):
    """Rows are image-major ([img0 crop0, img0 crop1, ...]); crops are
    finite, of the configured sizes, and in [0, 1] before normalization."""
    rng = np.random.default_rng(8)
    images = _t(rng.random((3, 60, 80, 3)))
    g, l = taug.multi_crop_batch(torch.Generator().manual_seed(0), images,
                                 2, 4, 32, 16)
    assert g.shape == (6, 32, 32, 3) and l.shape == (12, 16, 16, 3)
    mean = torch.tensor(taug.IMAGENET_MEAN)
    std = torch.tensor(taug.IMAGENET_STD)
    for crops in (g, l):
        raw = crops * std + mean
        assert torch.isfinite(crops).all()
        assert raw.min() >= -1e-5 and raw.max() <= 1 + 1e-5
    # layout: a stub crop that tags each crop with its image and call index
    calls = []

    def tagged(gen, imgs, spec):
        calls.append(spec.size)
        idx = torch.arange(imgs.shape[0], dtype=torch.float32)
        return (idx * 100 + len(calls)).reshape(-1, 1, 1, 1).expand(
            -1, spec.size, spec.size, 3)

    monkeypatch.setattr(taug, "augment_crop", tagged)
    g, l = taug.multi_crop_batch(torch.Generator(), images, 2, 4, 32, 16)
    assert g[:, 0, 0, 0].tolist() == [1, 2, 101, 102, 201, 202]
    assert l[:4, 0, 0, 0].tolist() == [3, 4, 5, 6]
    assert l[4:8, 0, 0, 0].tolist() == [103, 104, 105, 106]
    assert taug.multi_crop_batch(torch.Generator(), images, 2, 0, 32,
                                 16)[1] is None


def test_center_border_crop_matches_jax():
    frames = np.arange(2 * 50 * 70 * 3, dtype=np.uint8).reshape(2, 50, 70, 3)
    for args in ((0.8, 0.8, 0), (0.8, 0.7, 0), (0.8, 0.8, 13)):
        np.testing.assert_array_equal(taug.center_border_crop(frames, *args),
                                      jaug.center_border_crop(frames, *args))


# ---------------------------------------------------------------------------
# DINOTrainer against the JAX trainer
# ---------------------------------------------------------------------------

TINY = dict(image_size=32, patch_size=16, embed_dim=64, depth=2,
            num_heads=2)


def _dino_cfgs(**kw):
    base = dict(out_dim=128, batch_size=4, n_local_crops=2, global_size=32,
                local_size=16, epochs=1, warmup_epochs=0,
                freeze_last_layer_epochs=0, drop_path_rate=0.0,
                weight_decay=0.04, weight_decay_end=0.1)
    base.update(kw)
    return jdino.DINOConfig(**base), tdino.DINOConfig(**base)


def _crops(seed, b=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2 * b, 32, 32, 3)).astype(np.float32),
            rng.standard_normal((2 * b, 16, 16, 3)).astype(np.float32))


def _port_trainer(tcfg, state, optimizer, niter=2):
    trainer = tdino.DINOTrainer(ViTConfig(**TINY), tcfg, niter,
                                torch.Generator().manual_seed(0),
                                optimizer=optimizer, device="cpu",
                                fused_blocks=False)
    sd = dino_state_from_jax(state)
    trainer.student.load_state_dict(sd["student"])
    trainer.teacher.load_state_dict(sd["teacher"])
    trainer.center = sd["center"]
    return trainer


@pytest.mark.parametrize("optimizer,lr", [("sgd", 0.005), ("adamw", 1e-4)])
def test_trainer_steps_match_jax(optimizer, lr):
    """Two steps of the port's DINOTrainer (plain bf16 backbone, no drop
    path) against the JAX DINOTrainer(fused_blocks=False,
    fused_loss=False) from the same weights and crops.  The weights are
    the JAX init moved by 0.02 noise, so no tensor starts at 0 and the
    sgd limit, relative to each tensor's largest value, reads the update:
    XLA and PyTorch round bf16 at other places (XLA drops round trips
    inside its fusions), which moves each gradient by about 1%, so the lr
    keeps every update near 1% of the weights."""
    from sais_tpu.config import ViTConfig as JViTConfig
    jcfg, tcfg = _dino_cfgs(lr=lr * 256 / 4)
    jt = jdino.DINOTrainer(JViTConfig(**TINY), jcfg, 2, jax.random.key(0),
                           optimizer=optimizer, fused_blocks=False,
                           fused_loss=False)
    jt.student = jax.tree.map(
        lambda a: a + 0.02 * jax.random.normal(jax.random.key(a.size),
                                               a.shape), jt.student)
    jt.teacher = jax.tree.map(jnp.copy, jt.student)
    state = jax.tree.map(np.asarray, jt.state())
    # the center starts at 0; move it so centering is exercised
    state["center"] = np.random.default_rng(9).standard_normal(
        128).astype(np.float32) * 0.1
    jt.center = jnp.asarray(state["center"])
    tt = _port_trainer(tcfg, state, optimizer)
    before = {n: p.detach().clone() for n, p in tt.student.named_parameters()}
    lrs = []
    for step in range(2):
        g, l = _crops(step)
        lrs.append(float(jt.lr_sched[step]))
        ref = jt.step(jnp.asarray(g), jnp.asarray(l))
        got = tt.step(_t(g), _t(l))
        assert abs(got - ref) <= 2e-3 * abs(ref), (step, got, ref)
    ref_c = _np(jt.center)
    assert np.abs(_np(tt.center) - ref_c).max() <= 1e-3 * np.abs(ref_c).max()
    ref_sd = dino_state_from_jax(jax.tree.map(np.asarray, jt.state()))
    # Adam's update is at most lr a step (its second bias-corrected step
    # at most 1.0013 lr), and where a gradient is rounding noise (the key
    # bias, whose exact gradient is 0) the two sides may step apart
    tol = 2 * 1.0013 * sum(lrs)
    for n, p in tt.student.named_parameters():
        r = ref_sd["student"][n].numpy()
        moved = np.abs(r - before[n].numpy()).max()
        if n != "head.last_g":   # unused under norm_last_layer: it stays
            assert moved > 0, n
        err = np.abs(p.detach().numpy() - r).max()
        limit = (1e-3 * np.abs(r).max() if optimizer == "sgd" else tol)
        assert err <= limit, (n, err, limit, moved)
    assert tt.step_idx == 2


def test_checkpoint_resume_equals_uninterrupted(tmp_path):
    from sais_tpu_torch.train.checkpoint import CheckpointManager
    _, tcfg = _dino_cfgs(lr=0.5, drop_path_rate=0.1)

    def trainer():
        return tdino.DINOTrainer(ViTConfig(**TINY), tcfg, 2,
                                 torch.Generator().manual_seed(0),
                                 device="cpu", fused_blocks=True)

    crops = [tuple(map(_t, _crops(s))) for s in range(3)]
    full = trainer()
    losses = [full.step(*c) for c in crops]
    part = trainer()
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    assert mgr.restore_latest("template") == (None, "template")
    for i, c in enumerate(crops[:2]):
        part.step(*c)
        mgr.save(i + 1, part.state())
    mgr.save(3, part.state())
    assert mgr.steps() == [2, 3]
    resumed = trainer()
    step, state = mgr.restore_latest(resumed.state())
    assert step == 3
    resumed.load_state(state)
    assert resumed.step_idx == 2
    assert resumed.step(*crops[2]) == losses[2]
    for (n, a), b in zip(full.student.named_parameters(),
                         resumed.student.parameters()):
        assert torch.equal(a, b), n
    assert torch.equal(full.center, resumed.center)


def test_trainer_refusals_and_defaults():
    _, tcfg = _dino_cfgs()
    kw = dict(generator=torch.Generator(), device="cpu")
    # K7 is ported: fused_loss=True runs its plain version on the CPU, and
    # the BatchNorm head is refused with it as in the JAX package
    fused = tdino.DINOTrainer(ViTConfig(**TINY), tcfg, 2, fused_loss=True,
                              **kw)
    assert fused.fused_loss
    assert np.isfinite(fused.step(*map(_t, _crops(0))))
    with pytest.raises(ValueError, match="use_bn_in_head"):
        tdino.DINOTrainer(ViTConfig(**TINY),
                          tdino.DINOConfig(use_bn_in_head=True), 2,
                          fused_loss=True, **kw)
    # the BatchNorm head runs the plain head and loss (auto rule)
    bn = tdino.DINOTrainer(ViTConfig(**TINY), tdino.DINOConfig(
        **{**tcfg.__dict__, "use_bn_in_head": True}), 2, **kw)
    assert not bn.fused_loss and len(bn.student_bn) == 2
    big = tdino.DINOConfig(out_dim=32, batch_size=64)
    tr = tdino.DINOTrainer(ViTConfig(**TINY), big, 2, **kw)
    assert not tr.fused_blocks and not tr.fused_loss   # CPU: plain path
    with pytest.raises(FloatingPointError):
        tdino.DINOTrainer.check_loss(torch.tensor(float("nan")))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tdino.DINOTrainer(ViTConfig(**TINY), tcfg, 2,
                              torch.Generator())


def _synth_video(path, nframes, h=64, w=80):
    import cv2
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30,
                             (w, h))
    rng = np.random.default_rng(3)
    for _ in range(nframes):
        writer.write(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
    writer.release()


def test_cli_pretrain_e2e_and_resume(tmp_path, monkeypatch, capsys):
    """`pretrain --device cpu` end to end: video glob -> border crop ->
    shuffled batches -> multi-crop on the device -> DINO steps ->
    checkpoint + JSONL log; a second invocation resumes from the saved
    epoch.  --arch through the zoo, monkeypatched to a patch-32 depth-1
    ViT so the 224 / 96 reference crops stay cheap."""
    import json

    from sais_tpu_torch.cli import main as cli
    from sais_tpu_torch.models import zoo
    os.makedirs(tmp_path / "videos")
    _synth_video(str(tmp_path / "videos" / "vidP.mp4"), 24)
    tiny = ViTConfig(image_size=224, patch_size=32, embed_dim=64, depth=1,
                     num_heads=1)
    monkeypatch.setitem(zoo.CONFIGS, "vits16", tiny)
    args = ["pretrain", "-p", str(tmp_path), "-bs", "8", "--out-dim", "32",
            "--local-crops", "2", "--device", "cpu", "--loader-threads", "2"]
    cli.main(args + ["-e", "1"])
    out = tmp_path / "pretrain"
    lines = (out / "log.txt").read_text().strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["epoch"] == 0 and np.isfinite(rec["train_loss"])
    assert os.listdir(out / "ckpt") == ["1.pt"]
    capsys.readouterr()
    cli.main(args + ["-e", "2"])
    printed = capsys.readouterr().out
    assert "resumed from epoch 1" in printed and "epoch 1: loss" in printed
    assert sorted(os.listdir(out / "ckpt")) == ["1.pt", "2.pt"]


@pytest.mark.parametrize("flags,error,match", [
    (["--source", "flows"], SystemExit, "no flow dirs")])
def test_cli_pretrain_refusals(tmp_path, flags, error, match):
    """`--source flows` with an empty <root>/flows exits."""
    from sais_tpu_torch.cli import main as cli
    os.makedirs(tmp_path / "flows")
    with pytest.raises(error, match=match):
        cli.main(["pretrain", "-p", str(tmp_path), "--device", "cpu"]
                 + flags)


def test_zoo_configs_and_kernel_length_limit():
    """The zoo's geometries are JAX's, and the ViT-block kernels take every
    one of them at 224 px: the patch-8 archs' 785 tokens pass the kernels'
    geometry check (no length cap), as do 1025."""
    from sais_tpu.models import zoo as jzoo
    from sais_tpu_torch.kernels import fused_mha
    from sais_tpu_torch.models import zoo
    for name in list(jzoo.CONFIGS) + list(jzoo.ALIASES):
        j, t = jzoo.config(name), zoo.config(name)
        assert (j.patch_size, j.embed_dim, j.depth, j.num_heads) == (
            t.patch_size, t.embed_dim, t.depth, t.num_heads)
    with pytest.raises(KeyError):
        zoo.config("vitl16")
    assert not hasattr(zoo, "check_fused_length")
    for name in ("vits16", "vits8", "dino_vitb8", "vitb16"):
        cfg = zoo.config(name)
        tokens = (224 // cfg.patch_size) ** 2 + 1
        assert tokens == (785 if cfg.patch_size == 8 else 197)
        x = torch.zeros((1, tokens, cfg.embed_dim), dtype=torch.bfloat16)
        fused_mha._check_geometry(x, cfg.num_heads, tokens, 4 * cfg.embed_dim)
    fused_mha._check_geometry(torch.zeros((1, 1025, 384),
                                          dtype=torch.bfloat16), 6, 1000)


def test_shuffle_stream_and_logger_match_jax(tmp_path):
    """The port's own copies yield the same batches and log lines."""
    from sais_tpu.io.shuffle_stream import FrameShuffleStream as JStream
    from sais_tpu.utils.logging import MetricLogger as JLogger
    from sais_tpu_torch.io.shuffle_stream import FrameShuffleStream
    from sais_tpu_torch.utils.logging import MetricLogger

    frames = np.arange(40 * 2 * 2 * 3, dtype=np.uint8).reshape(40, 2, 2, 3)

    def sources():
        return [lambda i=i: iter(frames[i * 10:(i + 1) * 10])
                for i in range(4)]

    def run(cls):
        with cls(sources(), 8, buffer_frames=64, workers=1, seed=3) as s:
            return [b.copy() for b in s.batches()]

    got, ref = run(FrameShuffleStream), run(JStream)
    assert len(got) == 5
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    for cls, name in ((MetricLogger, "a.txt"), (JLogger, "b.txt")):
        log = cls(jsonl_path=str(tmp_path / name))
        for v in (1.0, 2.0, 4.0):
            log.update(loss=v)
        log.write_epoch(3, lr=0.5)
    assert (tmp_path / "a.txt").read_text() == (tmp_path / "b.txt"
                                                ).read_text()
