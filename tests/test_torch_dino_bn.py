"""The BatchNorm DINO head (--use-bn-in-head) in the port against the JAX
package: `_batch_norm` in train and eval mode (a batch of one included),
the BN head's forward and gradients, the reference state_dict's layout
(BatchNorm1d at Sequential indices 1 and 4), three DINOTrainer steps with
the BN head against JAX's from the same weights and crops, resume through
`state()` / `load_state` and the mismatched-state behaviour, and `pretrain
--use-bn-in-head` through both CLIs.

Numpy-seeded inputs go to both sides.  Limits: float32 paths within 1e-4
of the largest value (COMPONENTS C4 / C9); the trainer, whose backbone
and head run in bf16, at `tests/test_torch_dino.py`'s limits for the head
without BN (losses 2e-3 relative), parameters within 2e-3 of their
largest value after three sgd steps (two steps without BN hold 1e-3; the
BatchNorm divides the head's gradients by bf16 batch deviations, and the
cls token and a projection bias read 1.4e-3 here), the running statistics and the center within 1e-2 of their largest value
(they average the bf16 head's activations; see the test).
"""

import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn as nn

from sais_tpu.models import dino_head as jhead
from sais_tpu.train import dino as jdino
from sais_tpu_torch.config import ViTConfig
from sais_tpu_torch.models import dino_head as thead
from sais_tpu_torch.port.weights import (dino_head_bn_state_from_reference,
                                         dino_head_params_from_jax,
                                         dino_head_params_from_reference,
                                         dino_head_params_to_jax,
                                         dino_state_from_jax)
from sais_tpu_torch.train import dino as tdino


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, rel=1e-4):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), (err, rel)


def _state(rng, width):
    return {"mean": rng.standard_normal(width).astype(np.float32) * 0.1,
            "var": (1 + rng.random(width)).astype(np.float32)}


@pytest.mark.parametrize("train,n", [(True, 6), (True, 1), (False, 6)])
def test_batch_norm_matches_jax(train, n):
    """Normalized rows and the new running state.  At n = 1 both packages
    scale the variance by n / max(n - 1, 1) = 1 (torch's BatchNorm1d
    raises there), so the running variance takes the batch's 0."""
    rng = np.random.default_rng(n)
    h = rng.standard_normal((n, 16)).astype(np.float32) * 2 + 0.5
    bn = {"scale": (1 + 0.1 * rng.standard_normal(16)).astype(np.float32),
          "bias": (0.1 * rng.standard_normal(16)).astype(np.float32)}
    st = _state(rng, 16)
    want, want_st = jhead._batch_norm(
        jnp.asarray(h), jax.tree.map(jnp.asarray, bn),
        jax.tree.map(jnp.asarray, st), train)
    mod = thead.BatchNormAffine(16)
    mod.load_state_dict({k: _t(v) for k, v in bn.items()})
    got, got_st = thead._batch_norm(_t(h), mod,
                                    {k: _t(v) for k, v in st.items()}, train)
    _close(got, want)
    for k in ("mean", "var"):
        _close(got_st[k], want_st[k])
    if train and n == 1:
        np.testing.assert_allclose(_np(got_st["var"]), 0.9 * st["var"],
                                   rtol=1e-6)


def _bn_head_pair(in_dim=48, out_dim=96, hidden=64, bottleneck=32):
    params = jhead.dino_head_init(jax.random.key(0), in_dim, out_dim,
                                  hidden=hidden, bottleneck=bottleneck,
                                  use_bn=True)
    params = jax.tree.map(
        lambda a: a + 0.05 * jax.random.normal(jax.random.key(a.size),
                                               a.shape), params)
    head = thead.DINOHead(in_dim, out_dim, hidden, bottleneck, use_bn=True)
    head.load_state_dict(dino_head_params_from_jax(
        jax.tree.map(np.asarray, params)))
    return params, head


@pytest.mark.parametrize("train", [True, False])
def test_bn_head_forward_and_grads_match_jax(train):
    """float32: logits, the new running states and the gradients of a
    random projection of the logits with respect to every head parameter
    and the input, within 1e-4 of their largest value; the head's tree
    survives the trip to JAX and back."""
    params, head = _bn_head_pair()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((10, 48)).astype(np.float32)
    proj = rng.standard_normal((10, 96)).astype(np.float32)
    st = [_state(rng, 64), _state(rng, 64)]

    def jloss(p, x):
        out, new = jhead.dino_head_forward(
            p, x, True, bn_state=jax.tree.map(jnp.asarray, st), train=train)
        return jnp.sum(out * proj), (out, new)

    (_, (want, want_st)), (gp, gx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    got, got_st = thead.dino_head_forward(
        head, xt, True, bn_state=[{k: _t(v) for k, v in s.items()}
                                  for s in st], train=train)
    (got * _t(proj)).sum().backward()
    _close(got, want)
    for g, w in zip(got_st, want_st):
        for k in ("mean", "var"):
            _close(g[k], w[k])
    _close(xt.grad, gx)
    # the hidden biases' gradients are 0 up to rounding in train mode
    # (BatchNorm removes them with the batch mean), so every gradient is
    # held within 1e-4 of the largest one
    want_g = dino_head_params_from_jax(jax.tree.map(np.asarray, gp))
    scale = max(np.abs(v.numpy()).max() for v in want_g.values())
    for name, p in head.named_parameters():
        if name == "last_g":     # unused under norm_last_layer
            continue
        err = np.abs(_np(p.grad) - want_g[name].numpy()).max()
        assert err <= 1e-4 * scale, (name, err, scale)
    back = dino_head_params_to_jax(head.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, params))


def test_bn_head_bf16_runs_at_jax_precision():
    """bf16 input: bf16 MLP products, BatchNorm in float32 rounded back to
    bf16, as JAX's head; within 2e-2 of the largest logit (the head
    without BN's bf16 limit in tests/test_torch_dino.py)."""
    params, head = _bn_head_pair()
    x = np.random.default_rng(4).standard_normal((12, 48)).astype(
        np.float32)
    want, _ = jhead.dino_head_forward(
        params, jnp.asarray(x).astype(jnp.bfloat16), True,
        bn_state=jhead.dino_head_bn_init(params), train=True)
    got, st = thead.dino_head_forward(head, _t(x).bfloat16(), True,
                                      bn_state=thead.dino_head_bn_init(head))
    assert got.dtype == torch.float32 and len(st) == 2
    assert np.abs(_np(got) - _np(want)).max() <= 2e-2 * np.abs(
        _np(want)).max()
    with pytest.raises(ValueError, match="bn_state"):
        thead.dino_head_forward(head, _t(x))


def test_reference_bn_head_state_dict():
    """The reference's use_bn DINOHead (Linear, BatchNorm1d, GELU at
    Sequential indices 0-2 and 3-5, then Linear 6; the weight-normed last
    layer) loads with its running statistics, and the port's head matches
    torch's own module in train and eval mode, float32."""
    g = torch.Generator().manual_seed(0)
    mlp = nn.Sequential(nn.Linear(24, 32), nn.BatchNorm1d(32), nn.GELU(),
                        nn.Linear(32, 32), nn.BatchNorm1d(32), nn.GELU(),
                        nn.Linear(32, 16))
    last = nn.utils.weight_norm(nn.Linear(16, 40, bias=False))
    with torch.no_grad():
        for p in [*mlp.parameters(), *last.parameters()]:
            p.copy_(torch.randn(p.shape, generator=g) * 0.3 + 0.1)
        for m in (mlp[1], mlp[4]):
            m.running_mean.copy_(torch.randn(32, generator=g) * 0.1)
            m.running_var.copy_(1 + torch.rand(32, generator=g))
    sd = {**{f"mlp.{k}": v for k, v in mlp.state_dict().items()},
          **{f"last_layer.{k}": v for k, v in last.state_dict().items()}}
    head = thead.DINOHead(24, 40, 32, 16, use_bn=True)
    head.load_state_dict(dino_head_params_from_reference(sd))
    st = dino_head_bn_state_from_reference(sd)
    x = torch.randn(9, 24, generator=g)
    for train in (False, True):
        ref_mlp = copy.deepcopy(mlp).train(train)
        h = nn.functional.normalize(ref_mlp(x), dim=-1)
        want = last(h)
        got, new = thead.dino_head_forward(head, x, norm_last_layer=False,
                                           bn_state=st, train=train)
        _close(got, want.detach(), 1e-5)
        for s, m in zip(new, (ref_mlp[1], ref_mlp[4])):
            _close(s["mean"], m.running_mean, 1e-5)
            _close(s["var"], m.running_var, 1e-5)


TINY = dict(image_size=32, patch_size=16, embed_dim=64, depth=2,
            num_heads=2)


def _cfgs(**kw):
    base = dict(out_dim=128, batch_size=4, n_local_crops=2, global_size=32,
                local_size=16, epochs=1, warmup_epochs=0,
                freeze_last_layer_epochs=0, drop_path_rate=0.0,
                weight_decay=0.04, weight_decay_end=0.1,
                use_bn_in_head=True)
    base.update(kw)
    return jdino.DINOConfig(**base), tdino.DINOConfig(**base)


def _crops(seed, b=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2 * b, 32, 32, 3)).astype(np.float32),
            rng.standard_normal((2 * b, 16, 16, 3)).astype(np.float32))


def _port_from_jax(tcfg, state, optimizer="sgd", niter=3):
    trainer = tdino.DINOTrainer(ViTConfig(**TINY), tcfg, niter,
                                torch.Generator().manual_seed(0),
                                optimizer=optimizer, device="cpu",
                                fused_blocks=False)
    sd = dino_state_from_jax(state)
    trainer.student.load_state_dict(sd["student"])
    trainer.teacher.load_state_dict(sd["teacher"])
    trainer.center = sd["center"]
    trainer.student_bn, trainer.teacher_bn = sd["student_bn"], \
        sd["teacher_bn"]
    return trainer


def test_trainer_bn_steps_match_jax():
    """Three steps with the BatchNorm head (plain bf16 backbone and head,
    no drop path, sgd) against JAX's DINOTrainer(fused_blocks=False,
    fused_loss=False) from the same weights and crops: losses, the
    center, every parameter (BN scales and biases included) and both
    running states.

    Both sides round their products to bf16 in different summation
    orders (XLA against PyTorch), and BatchNorm, normalizing over 8 to
    24 rows, magnifies that rounding; the float32 head above holds the
    same arithmetic to 1e-4.  Readings here (max|diff| / max|JAX|):
    parameters 1.37e-3 at most (backbone.cls_token), the center 3.7e-3,
    the running means 2.8e-3, the running variances 6.9e-3; every
    parameter that a gradient moves is off by at most 0.12 of its own
    three-step movement (backbone.blocks.1.mlp.fc2.bias).  The limits are
    these readings with some room: 2e-3, 5e-3, 5e-3, 1e-2, and a quarter
    of the movement, so a missing or wrong update fails however small it
    is beside the tensor."""
    from sais_tpu.config import ViTConfig as JViTConfig
    jcfg, tcfg = _cfgs(lr=0.005 * 256 / 4)
    jt = jdino.DINOTrainer(JViTConfig(**TINY), jcfg, 3, jax.random.key(0),
                           optimizer="sgd", fused_blocks=False,
                           fused_loss=False)
    jt.student = jax.tree.map(
        lambda a: a + 0.02 * jax.random.normal(jax.random.key(a.size),
                                               a.shape), jt.student)
    jt.teacher = jax.tree.map(jnp.copy, jt.student)
    state = jax.tree.map(np.asarray, jt.state())
    tt = _port_from_jax(tcfg, state)
    assert not tt.fused_loss and len(tt.student_bn) == 2
    before = {n: p.detach().clone() for n, p in tt.student.named_parameters()}
    bn_before = [dict(s) for s in tt.student_bn + tt.teacher_bn]
    for step in range(3):
        g, l = _crops(step)
        ref = jt.step(jnp.asarray(g), jnp.asarray(l))
        got = tt.step(_t(g), _t(l))
        assert abs(got - ref) <= 2e-3 * abs(ref), (step, got, ref)
    ref_c = _np(jt.center)
    assert np.abs(_np(tt.center) - ref_c).max() <= 5e-3 * np.abs(ref_c).max()
    ref_sd = dino_state_from_jax(jax.tree.map(np.asarray, jt.state()))
    # BatchNorm makes these gradients exactly 0 (a bias the batch mean
    # removes); head.last_g is unused under norm_last_layer.  They move
    # by rounding noise at most.
    still = ("head.mlp.0.bias", "head.mlp.1.bias", "backbone.norm.bias",
             "head.last_g")
    for n, p in tt.student.named_parameters():
        r = ref_sd["student"][n].numpy()
        top = np.abs(r).max()
        moved = np.abs(r - before[n].numpy()).max()
        err = np.abs(p.detach().numpy() - r).max()
        assert err <= 2e-3 * top, (n, err)
        if n in still:
            assert moved <= 1e-4 * top, (n, moved)
        else:
            assert err <= moved / 4, (n, err, moved)
    for got_s, want_s, was in zip(tt.student_bn + tt.teacher_bn,
                                  ref_sd["student_bn"] + ref_sd["teacher_bn"],
                                  bn_before):
        for k, rel in (("mean", 5e-3), ("var", 1e-2)):
            _close(got_s[k], want_s[k], rel)
            moved = np.abs(_np(want_s[k]) - _np(was[k])).max()
            assert np.abs(_np(got_s[k]) - _np(want_s[k])).max() <= moved / 4
    # the teacher's state moved from its own forwards, not the student's
    assert not torch.equal(tt.student_bn[0]["mean"], tt.teacher_bn[0]["mean"])
    assert all(not s["mean"].requires_grad for s in tt.student_bn)


def test_trainer_bn_resume_and_mismatched_state(tmp_path):
    """A BN trainer resumed through `state()` / `load_state` (and the
    CheckpointManager's file) steps as the uninterrupted one, bitwise;
    `load_state` takes a BN state into a trainer without the BN head, and
    keeps its own when the state has none, without a word, as JAX's; an
    explicit fused_loss with the BN head raises JAX's ValueError, and the
    auto rule picks the plain head."""
    from sais_tpu_torch.train.checkpoint import CheckpointManager
    _, tcfg = _cfgs(lr=0.5)

    def trainer(cfg=tcfg):
        return tdino.DINOTrainer(ViTConfig(**TINY), cfg, 3,
                                 torch.Generator().manual_seed(0),
                                 device="cpu", fused_blocks=False)

    crops = [tuple(map(_t, _crops(s))) for s in range(3)]
    full = trainer()
    losses = [full.step(*c) for c in crops]
    part = trainer()
    for c in crops[:2]:
        part.step(*c)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(2, part.state())
    resumed = trainer()
    resumed.load_state(mgr.restore_latest(resumed.state())[1])
    assert resumed.step(*crops[2]) == losses[2]
    for a, b in zip(full.student_bn + full.teacher_bn,
                    resumed.student_bn + resumed.teacher_bn):
        assert torch.equal(a["mean"], b["mean"])
        assert torch.equal(a["var"], b["var"])
    plain_cfg = tdino.DINOConfig(**{**tcfg.__dict__, "use_bn_in_head": False})
    plain = trainer(plain_cfg)
    st = plain.state()
    st["student_bn"], st["teacher_bn"] = full.student_bn, full.teacher_bn
    plain.load_state(st)
    assert plain.student_bn is not None
    assert np.isfinite(plain.step(*crops[0]))
    own = [dict(s) for s in resumed.student_bn]
    no_bn = {k: v for k, v in part.state().items()
             if not k.endswith("_bn")}
    resumed.load_state(no_bn)
    assert all(torch.equal(a["mean"], b["mean"])
               for a, b in zip(resumed.student_bn, own))
    with pytest.raises(ValueError, match="use_bn_in_head"):
        tdino.DINOTrainer(ViTConfig(**TINY), tcfg, 2, torch.Generator(),
                          fused_loss=True, device="cpu")
    assert not tdino.fused_loss_auto(tcfg, torch.device("cuda"))
