"""K2 (sais_tpu_torch.kernels.flash_attention) and the flash path of the
temporal model against the JAX package on the CPU.  The JAX side runs its
Pallas kernel in interpret mode, as tests/test_flash_attention.py does;
the port's wrappers run their plain version because the tensors lie on the
CPU.  The CUDA kernel is held against the plain version on the card in
tests/test_torch_cuda.py."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sais_tpu.config import ModelConfig as JModelConfig
from sais_tpu.config import TemporalConfig as JTemporalConfig
from sais_tpu.kernels import flash_attention as jfa
from sais_tpu.models import full_model as jfm
from sais_tpu.models import heads as jheads
from sais_tpu.models.temporal import encoder_forward as jax_encoder
from sais_tpu_torch.config import ModelConfig, TemporalConfig
from sais_tpu_torch.kernels.flash_attention import (cls_attention_row,
                                                    flash_attention,
                                                    flash_attention_fwd,
                                                    flash_attention_reference,
                                                    key_bias)
from sais_tpu_torch.models import full_model as tfm
from sais_tpu_torch.models import heads as theads
from sais_tpu_torch.models.temporal import encoder_forward
from sais_tpu_torch.port.weights import full_model_params_from_jax


def _qkv(seed, b, h, l, dh):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, h, l, dh)).astype(np.float32)
                 for _ in range(3))


def _tail_mask(b, l, all_masked=None):
    """Masked tails that differ per batch element (element i keeps
    l - 7 i keys); `all_masked` names an element with every key masked."""
    mask = np.zeros((b, l), bool)
    for i in range(b):
        mask[i, l - 7 * i:] = True
    if all_masked is not None:
        mask[all_masked] = True
    return mask


def _t(*arrays):
    return tuple(torch.tensor(a) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


@pytest.mark.parametrize("l,dh", [(37, 96), (130, 64)])
def test_flash_attention_matches_pallas(l, dh):
    """f32, masked tails and one all-masked element.  Limit 2e-5, the
    JAX package's own limit between its kernel and dense attention: both
    sides compute in f32 and differ in summation order only."""
    q, k, v = _qkv(l, 3, 4, l, dh)
    mask = _tail_mask(3, l, all_masked=2)
    ref = np.asarray(jfa.flash_attention(*_j(q, k, v, mask), interpret=True))
    got = flash_attention(*_t(q, k, v, mask)).numpy()
    assert got.shape == ref.shape == (3, 4, l, dh)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
    assert not got[2].any() and not ref[2].any()


def _padded_like_jax(q, k, v, bias, l):
    """The padding `flash_attention` applies before `_run_fwd`: L to the
    block step (blocks clamped to the 128-aligned length) with -1e30 keys,
    Dh to 128 lanes."""
    lmax = max(l + (-l) % 128, 128)
    step = math.lcm(min(512, lmax), min(512, lmax))
    lp = l + (-l) % step

    def pad(x):
        return np.pad(x, [(0, 0), (0, 0), (0, lp - l),
                          (0, 128 - x.shape[-1])])

    return (pad(q), pad(k), pad(v),
            np.pad(bias, [(0, 0), (0, lp - l)], constant_values=-1e30), lp)


def test_lse_matches_run_fwd():
    """The port's exact-shape (out, lse) against `_run_fwd` in interpret
    mode on inputs padded as `flash_attention` pads them: the -1e30 pad
    keys add exactly 0 wherever a row has a valid key.  Limit 2e-5 (f32,
    summation order).  The all-masked element's lse is -1e30 on both
    sides (log of the key count vanishes next to it); its out, which
    `flash_attention` zeroes, averages the zero pad rows of v on the TPU
    and is not compared."""
    l, dh = 130, 96
    q, k, v = _qkv(3, 3, 4, l, dh)
    mask = _tail_mask(3, l, all_masked=1)
    bias = np.where(mask, -1e30, 0.0).astype(np.float32)
    qp, kp, vp, bp, lp = _padded_like_jax(q, k, v, bias, l)
    jout, jlse = jfa._run_fwd(*_j(qp, kp, vp, bp), dh ** -0.5, lp, lp, True)
    jout, jlse = np.asarray(jout)[:, :, :l, :dh], np.asarray(jlse)[:, :, :l]
    out, lse = flash_attention_fwd(*_t(q, k, v, bias))
    assert out.shape == (3, 4, l, dh) and lse.shape == (3, 4, l)
    np.testing.assert_allclose(out.numpy()[[0, 2]], jout[[0, 2]],
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), jlse, rtol=2e-5, atol=2e-5)
    assert (lse.numpy()[1] == np.float32(-1e30)).all()


def test_all_masked_element_gives_zeros():
    """`flash_attention` zeroes an element whose keys are all masked (the
    JAX package's definition); `flash_attention_fwd`, like `_run_fwd`,
    gives the unmasked average of v there, with lse = -1e30 + log(L)."""
    l, dh = 40, 64
    q, k, v = _qkv(5, 2, 2, l, dh)
    mask = np.zeros((2, l), bool)
    mask[1] = True
    out = flash_attention(*_t(q, k, v, mask))
    assert torch.count_nonzero(out[1]) == 0
    ref, _ = flash_attention_reference(*_t(q, k, v))
    torch.testing.assert_close(out[0], ref[0], rtol=0, atol=0)
    fwd, lse = flash_attention_fwd(*_t(q, k, v),
                                   key_bias(torch.tensor(mask)))
    mean_v = torch.tensor(v[1]).mean(1, keepdim=True).expand(2, l, dh)
    torch.testing.assert_close(fwd[1], mean_v, rtol=1e-5, atol=1e-5)
    assert (lse[1] == np.float32(-1e30)).all()


def test_cpu_tensor_runs_plain_version_without_counting():
    q, k, v = _t(*_qkv(6, 1, 2, 20, 64))
    before = flash_attention.launches
    out = flash_attention(q, k, v)
    assert flash_attention.launches == before
    torch.testing.assert_close(out, flash_attention_reference(q, k, v)[0],
                               rtol=0, atol=0)


def test_cls_attention_row_matches_jax():
    """Limit 1e-6: a softmax of the same f32 logits."""
    q, k, _ = _qkv(7, 3, 4, 61, 96)
    mask = _tail_mask(3, 61)
    ref = np.asarray(jfa.cls_attention_row(*_j(q, k, mask)))
    got = cls_attention_row(*_t(q, k, mask)).numpy()
    assert got.shape == (3, 61)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


TEMP = dict(rep_dim=64, num_layers=2, num_heads=4, ffn_dim=128)


def _temporal_pair(seed, use_flash):
    jcfg = JModelConfig(rep_dim=64, modalities="RGB",
                        temporal=JTemporalConfig(**TEMP, use_flash=use_flash))
    cfg = ModelConfig(rep_dim=64, modalities="RGB",
                      temporal=TemporalConfig(**TEMP, use_flash=use_flash))
    jparams = jfm.full_model_init(jax.random.key(seed), jcfg)
    model = tfm.FullModel(cfg)
    model.load_state_dict(full_model_params_from_jax(jparams))
    return jparams, jcfg, model, cfg


def test_encoder_flash_matches_jax():
    """Two layers, D 64, 4 heads, L 130 with a masked tail: output and the
    last layer's CLS-row attention within 1e-4, the temporal model's
    limit against the JAX package (f32, summation order)."""
    jparams, jcfg, model, cfg = _temporal_pair(0, True)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 130, 64)).astype(np.float32)
    mask = _tail_mask(3, 130)
    ref_out, ref_attn = jax_encoder(jparams["frame_encoder"], jnp.asarray(x),
                                    jcfg.temporal, jnp.asarray(mask),
                                    use_flash=True, interpret=True)
    with torch.no_grad():
        out, attn = encoder_forward(model.frame_encoder, torch.tensor(x),
                                    cfg.temporal, torch.tensor(mask),
                                    use_flash=True)
    assert attn.shape == (3, 130)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=1e-4)
    np.testing.assert_allclose(attn.numpy(), np.asarray(ref_attn), atol=1e-4)


def test_prototypes_forward_flash_matches_jax_and_dense():
    """prototypes_forward with use_flash=True (K2's plain version here)
    against the JAX package's flash path in interpret mode, within 1e-4;
    the CLS row it exports equals row 0 of the dense path's matrix."""
    jparams, jcfg, model, cfg = _temporal_pair(1, True)
    rng = np.random.default_rng(9)
    rgb = rng.standard_normal((4, 1, 129, 64)).astype(np.float32)
    mask = np.zeros((4, 1, 130), bool)
    mask[1, 0, 90:] = True
    protos = rng.random((3, 256)).astype(np.float32)
    ref = jfm.prototypes_forward(jparams, jcfg, *_j(rgb, mask))
    ref_probs = np.asarray(jheads.prototype_probs(ref.video_rep,
                                                  jnp.asarray(protos)))
    with torch.no_grad():
        out = tfm.prototypes_forward(model, cfg, *_t(rgb, mask))
        probs = theads.prototype_probs(out.video_rep, torch.tensor(protos))
        dense_cfg = ModelConfig(rep_dim=64, modalities="RGB",
                                temporal=TemporalConfig(**TEMP,
                                                        use_flash=False))
        dense = tfm.prototypes_forward(model, dense_cfg, *_t(rgb, mask))
    assert out.attn.shape == (4, 130) and dense.attn.shape == (4, 130, 130)
    for got, want in ((out.video_rep, ref.video_rep), (out.attn, ref.attn),
                      (probs, ref_probs)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(out.attn.numpy(),
                               tfm.cls_attention(dense.attn).numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(out.video_rep.numpy(),
                               dense.video_rep.numpy(), atol=1e-4)


def test_resolve_flash_rule():
    """Auto: K2 on a CUDA device at >= flash_min_len tokens, dense on the
    CPU; forced values honored.  Only the device type is read, so no card
    is needed."""
    auto = ModelConfig()
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert tfm.resolve_flash(auto, 512, cuda) is True
    assert tfm.resolve_flash(auto, 2001, cuda) is True
    assert tfm.resolve_flash(auto, 511, cuda) is False
    assert tfm.resolve_flash(auto, 2001, cpu) is False
    for forced in (True, False):
        cfg = ModelConfig(temporal=TemporalConfig(use_flash=forced))
        assert tfm.resolve_flash(cfg, 16, cpu) is forced
        assert tfm.resolve_flash(cfg, 4096, cuda) is forced
