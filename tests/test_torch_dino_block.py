"""The port's ViT-block training kernels' plain versions (K4, K5, K6), the
TrainableFusedBlock Function and the fused training backbone against the
JAX package's Pallas kernels, run with interpret=True on the CPU.

The same numpy-seeded inputs go to both.  Limits: float32 block output
1e-4; float32 gradients rtol 2e-3 / atol 2e-4 (the JAX package's own
Pallas-vs-twin limits, tests/test_fused_backward.py); bf16 2e-2 of the
largest value (an ulp or two, 2**-8, where the two sides sum in another
order); the bf16 backbone's features 2e-2 and each parameter gradient
5e-2 of its largest value (two bf16 blocks and the bf16 patch embedding
between them).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sais_tpu.kernels.fused_mha import (_fused_block_bwd_attn,
                                        _fused_block_bwd_mlp,
                                        _fused_block_fwd_train,
                                        make_pallas_trainable_fused_block)
from sais_tpu_torch.kernels.fused_mha import (fused_block_bwd_attn,
                                              fused_block_bwd_mlp,
                                              fused_block_fwd_train,
                                              trainable_fused_block)

HEADS, D, MLP = 2, 64, 256


def _weights(seed):
    rng = np.random.default_rng(seed)
    shapes = [(D, 3 * D), (3 * D,), (D, D), (D,), (D, MLP), (MLP,),
              (MLP, D), (D,), (D,), (D,), (D,), (D,)]
    ws = [0.05 * rng.standard_normal(s).astype(np.float32) for s in shapes]
    ws[8] += 1.0    # LN scales near 1
    ws[10] += 1.0
    return ws


def _scales(b, l, seed):
    """Per-image branch scales in {0, 1/0.9}, image 0's attention branch
    and image 1's MLP branch dropped, as (B, L, 1) float32."""
    rng = np.random.default_rng(seed)
    keep = (rng.random((2, b)) < 0.7).astype(np.float32)
    keep[0, 0] = keep[1, 1] = 0.0
    return [np.broadcast_to(k[:, None, None] / np.float32(0.9),
                            (b, l, 1)).astype(np.float32) for k in keep]


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32)).astype(dtype)


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32)) if not isinstance(
        a, torch.Tensor) else a.detach().float().numpy()


# (B, L, valid, scaled): L = 20 takes JAX's packed block-diagonal attention
# (4 images a sub-group), L = 72 its per-image loop
CASES = [(4, 20, 20, False), (4, 20, 13, True), (2, 72, 70, True)]


@pytest.mark.parametrize("b,l,valid,scaled", CASES)
def test_train_forward_plain_matches_pallas(b, l, valid, scaled):
    ws = _weights(l)
    x = np.random.default_rng(1).standard_normal((b, l, D)).astype(np.float32)
    s1, s2 = _scales(b, l, 2) if scaled else (None, None)
    out, x1 = _fused_block_fwd_train(
        _j(x), *map(_j, ws), num_heads=HEADS, valid_len=valid, eps=1e-6,
        interpret=True, s1=None if s1 is None else _j(s1),
        s2=None if s2 is None else _j(s2))
    got_out, got_x1 = fused_block_fwd_train(
        _t(x), *map(_t, ws), num_heads=HEADS, valid_len=valid,
        s1=None if s1 is None else _t(s1), s2=None if s2 is None else _t(s2))
    np.testing.assert_allclose(_np(got_x1), _np(x1), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(got_out), _np(out), rtol=1e-4, atol=1e-4)


MLP_NAMES = ("dx1", "dfc1_w", "dfc1_b", "dfc2_w", "dfc2_b", "dln2_s",
             "dln2_b")
ATTN_NAMES = ("dx", "dqkv_w", "dqkv_b", "dproj_w", "dproj_b", "dln1_s",
              "dln1_b")


def _assert_grads(names, got, ref, dtype):
    for name, a, r in zip(names, got, ref):
        a, r = _np(a), _np(r).reshape(a.shape)
        if dtype == np.float32:
            np.testing.assert_allclose(a, r, rtol=2e-3, atol=2e-4,
                                       err_msg=name)
        else:
            assert np.abs(a - r).max() <= 2e-2 * np.abs(r).max(), name


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("b,l,valid,scaled", CASES)
def test_mlp_backward_plain_matches_pallas(b, l, valid, scaled, dtype):
    ws = _weights(l + 1)
    rng = np.random.default_rng(3)
    x1 = rng.standard_normal((b, l, D)).astype(np.float32)
    dout = rng.standard_normal((b, l, D)).astype(np.float32)
    s2 = _scales(b, l, 4)[1] if scaled else None
    jd, td = ((jnp.float32, torch.float32) if dtype == np.float32
              else (jnp.bfloat16, torch.bfloat16))
    mw = [ws[i] for i in (4, 5, 6, 7, 10, 11)]
    ref = _fused_block_bwd_mlp(_j(x1, jd), _j(dout, jd),
                               *(_j(w, jd) for w in mw), eps=1e-6,
                               interpret=True,
                               s2=None if s2 is None else _j(s2, jd))
    got = fused_block_bwd_mlp(_t(x1, td), _t(dout, td),
                              *(_t(w, td) for w in mw),
                              s2=None if s2 is None else _t(s2, td))
    assert got[0].dtype == td and all(g.dtype == torch.float32
                                      for g in got[1:])
    _assert_grads(MLP_NAMES, got, ref, dtype)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("b,l,valid,scaled", CASES)
def test_attn_backward_plain_matches_pallas(b, l, valid, scaled, dtype):
    ws = _weights(l + 2)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((b, l, D)).astype(np.float32)
    dx1 = rng.standard_normal((b, l, D)).astype(np.float32)
    s1 = _scales(b, l, 6)[0] if scaled else None
    jd, td = ((jnp.float32, torch.float32) if dtype == np.float32
              else (jnp.bfloat16, torch.bfloat16))
    aw = [ws[i] for i in (0, 1, 2, 3, 8, 9)]
    ref = _fused_block_bwd_attn(_j(x, jd), _j(dx1, jd),
                                *(_j(w, jd) for w in aw), num_heads=HEADS,
                                valid_len=valid, eps=1e-6, interpret=True,
                                s1=None if s1 is None else _j(s1, jd))
    got = fused_block_bwd_attn(_t(x, td), _t(dx1, td),
                               *(_t(w, td) for w in aw), num_heads=HEADS,
                               valid_len=valid,
                               s1=None if s1 is None else _t(s1, td))
    _assert_grads(ATTN_NAMES, got, ref, dtype)


@pytest.mark.parametrize("scaled", [False, True])
def test_trainable_block_gradients_match_jax_vjp(scaled):
    """TrainableFusedBlock's gradients against jax.vjp of
    make_pallas_trainable_fused_block(interpret=True), float32, at the
    packed local-crop geometry; the scales get no gradient."""
    b, l, valid = 4, 20, 17
    ws = _weights(7)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((b, l, D)).astype(np.float32)
    g = rng.standard_normal((b, l, D)).astype(np.float32)
    s1, s2 = _scales(b, l, 9)
    op = make_pallas_trainable_fused_block(HEADS, valid, interpret=True,
                                           scaled=scaled)
    jargs = ((_j(x), _j(s1), _j(s2)) if scaled else (_j(x),)) + tuple(
        map(_j, ws))
    out, vjp = jax.vjp(op, *jargs)
    ref = vjp(_j(g))
    ref = (ref[0],) + tuple(ref[3:] if scaled else ref[1:])

    tx = _t(x).requires_grad_()
    tws = [_t(w).requires_grad_() for w in ws]
    ts1, ts2 = (_t(s1).requires_grad_(), _t(s2).requires_grad_()) \
        if scaled else (None, None)
    got_out = trainable_fused_block(tx, tws, HEADS, valid, s1=ts1, s2=ts2)
    got_out.backward(_t(g))
    np.testing.assert_allclose(_np(got_out), _np(out), rtol=1e-4, atol=1e-4)
    for i, (a, r) in enumerate(zip([tx.grad] + [w.grad for w in tws], ref)):
        np.testing.assert_allclose(_np(a), _np(r).reshape(a.shape),
                                   rtol=2e-3, atol=2e-4, err_msg=str(i))
    if scaled:
        assert ts1.grad is None and ts2.grad is None


def test_trainable_fused_backbone_matches_jax():
    """vit_features_trainable_fused with JAX's stochastic-depth draws
    injected: CLS features and every parameter gradient against the JAX
    package's fused training path (bf16 Pallas kernels in interpret
    mode)."""
    from sais_tpu.config import ViTConfig as JViTConfig
    from sais_tpu.models.vit import drop_path_scales as jax_scales
    from sais_tpu.models.vit import vit_features_trainable_fused as jax_fused
    from sais_tpu.models.vit import vit_init as jax_vit_init
    from sais_tpu_torch.config import ViTConfig
    from sais_tpu_torch.models.vit import (VisionTransformer,
                                           vit_features_trainable_fused)
    from sais_tpu_torch.port.weights import vit_params_from_jax

    kw = dict(image_size=32, patch_size=16, embed_dim=D, depth=2,
              num_heads=HEADS)
    jcfg, cfg = JViTConfig(**kw), ViTConfig(**kw)
    params = jax_vit_init(jax.random.key(0), jcfg)
    params = jax.tree.map(
        lambda a: a + 0.02 * jax.random.normal(jax.random.key(1), a.shape),
        params)   # non-trivial LN and biases
    b, rate, key = 6, 0.5, jax.random.key(2)
    images = np.random.default_rng(3).standard_normal(
        (b, 32, 32, 3)).astype(np.float32)
    cot = np.random.default_rng(4).standard_normal((b, D)).astype(np.float32)

    def loss(p):
        f = jax_fused(p, _j(images), jcfg, interpret=True,
                      drop_path_rate=rate, rng=key)
        return jnp.sum(f * _j(cot)), f

    (_, feats), grads = jax.value_and_grad(loss, has_aux=True)(params)

    # the draws vit_features_trainable_fused makes from `key`
    depth = jcfg.depth
    rngs = jax.random.split(key, 2 * depth)
    scales = []
    for i in range(depth):
        keep = 1.0 - rate * i / max(depth - 1, 1)
        scales.append(tuple(
            _t(np.asarray(jax_scales(rngs[2 * i + j], keep, b)
                          .astype(jnp.bfloat16), np.float32))
            for j in range(2)))
    assert any((s == 0).any() for pair in scales for s in pair)

    model = VisionTransformer(cfg)
    model.load_state_dict(vit_params_from_jax(jax.tree.map(np.asarray,
                                                           params)))
    got = vit_features_trainable_fused(model, _t(images), scales=scales)
    (got * _t(cot)).sum().backward()
    f_ref = _np(feats)
    assert np.abs(_np(got) - f_ref).max() <= 2e-2 * np.abs(f_ref).max()
    ref_grads = vit_params_from_jax(jax.tree.map(
        lambda a: np.asarray(a, np.float32), grads))
    for name, p in model.named_parameters():
        r = ref_grads[name].numpy()
        err = np.abs(p.grad.numpy() - r).max()
        assert err <= 5e-2 * np.abs(r).max(), (name, err, np.abs(r).max())
