"""Port models against the JAX package on the CPU: the ViT (float32 path,
bf16 fused path, pos-embedding interpolation, DINO checkpoints) and the
temporal encoder, prototypes forward and prototype head.  The same weights
reach both sides: JAX pytrees carried across with `port.weights`, or a
random DINO state_dict from tests/golden."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sais_tpu.config import ModelConfig as JModelConfig
from sais_tpu.config import TemporalConfig as JTemporalConfig
from sais_tpu.config import ViTConfig as JViTConfig
from sais_tpu.models import full_model as jfm
from sais_tpu.models import heads as jheads
from sais_tpu.models import vit as jvit
from sais_tpu_torch.config import ModelConfig, TemporalConfig, ViTConfig
from sais_tpu_torch.models import full_model as tfm
from sais_tpu_torch.models import heads as theads
from sais_tpu_torch.models.temporal import encoder_forward
from sais_tpu_torch.models.vit import VisionTransformer, vit_features
from sais_tpu_torch.port.weights import (full_model_params_from_jax,
                                         vit_params_from_jax)

VIT = dict(image_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4)
TEMP = dict(rep_dim=32, num_layers=2, num_heads=4, ffn_dim=64)


def _vit_pair(seed=0, **over):
    kw = dict(VIT, **over)
    jparams = jvit.vit_init(jax.random.key(seed), JViTConfig(**kw))
    model = VisionTransformer(ViTConfig(**kw))
    model.load_state_dict(vit_params_from_jax(jparams))
    return jparams, JViTConfig(**kw), model


def _images(seed, n=3, hw=32):
    return np.random.default_rng(seed).standard_normal(
        (n, hw, hw, 3)).astype(np.float32)


@pytest.mark.parametrize("hw", [32, 48])   # 48: pos-embed interpolation
def test_vit_f32_matches_jax(hw):
    jparams, jcfg, model = _vit_pair()
    x = _images(1, hw=hw)
    ref = np.asarray(jvit.vit_features(jparams, jnp.asarray(x), jcfg))
    with torch.no_grad():
        got = vit_features(model, torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("hw", [32, 40])
def test_vit_bf16_fused_matches_jax_fused(hw):
    """bf16 fused path (K1's plain version on the CPU) against the JAX
    fused path with the Pallas block in interpret mode.  Both round at the
    same points; the LayerNormed CLS features (|x| < 4) may differ by a
    couple of bf16 ulps (2**-6 in [2, 4))."""
    jparams, jcfg, model = _vit_pair(seed=2)
    x = _images(3, hw=hw)
    ref = np.asarray(jvit.vit_features_trainable_fused(
        jparams, jnp.asarray(x), jcfg, interpret=True, backward="xla"))
    with torch.no_grad():
        got = vit_features(model.to(torch.bfloat16), torch.tensor(x)).numpy()
    assert np.abs(ref).max() < 4.0
    np.testing.assert_allclose(got, ref, rtol=0, atol=2 * 2.0 ** -6)


def test_vit_without_qkv_bias_matches_jax():
    jparams, jcfg, model = _vit_pair(seed=4, qkv_bias=False)
    assert model.blocks[0].attn.qkv.bias is None
    x = _images(5)
    ref = np.asarray(jvit.vit_features(jparams, jnp.asarray(x), jcfg))
    with torch.no_grad():
        got = vit_features(model, torch.tensor(x)).numpy()
        fused = vit_features(model.to(torch.bfloat16), torch.tensor(x))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    assert torch.isfinite(fused).all()


def test_dino_state_dict_loads_as_is():
    """A random DINO-named state_dict: load_state_dict on the port side,
    vit_params_from_torch on the JAX side, same features."""
    from sais_tpu.port.torch_port import vit_params_from_torch
    from sais_tpu_torch.port.weights import strip_dino_prefixes
    from tests.golden.torch_vit import random_dino_state_dict

    sd = random_dino_state_dict(torch.Generator().manual_seed(0), depth=2,
                                dim=64, heads=4, patch=8, img=32)
    model = VisionTransformer(ViTConfig(**VIT))
    wrapped = {"student": {f"module.backbone.{k}": v for k, v in sd.items()}}
    model.load_state_dict(strip_dino_prefixes(wrapped))
    x = _images(6)
    ref = np.asarray(jvit.vit_features(vit_params_from_torch(sd),
                                       jnp.asarray(x), JViTConfig(**VIT)))
    with torch.no_grad():
        got = vit_features(model, torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_vit_params_from_jax_layout():
    jparams, _, model = _vit_pair(seed=7)
    sd = model.state_dict()
    np.testing.assert_array_equal(
        sd["blocks.1.attn.qkv.weight"].numpy(),
        np.asarray(jparams["blocks"][1]["attn"]["qkv_w"]).T)
    # conv kernel (D, C, kh, kw) flattens back to the patchify order
    w = sd["patch_embed.proj.weight"].permute(2, 3, 1, 0).reshape(-1, 64)
    np.testing.assert_array_equal(w.numpy(),
                                  np.asarray(jparams["patch_embed"]["w"]))


def _temporal_pair(seed=0, modalities="RGB"):
    jcfg = JModelConfig(rep_dim=32, modalities=modalities,
                        temporal=JTemporalConfig(**TEMP))
    cfg = ModelConfig(rep_dim=32, modalities=modalities,
                      temporal=TemporalConfig(**TEMP))
    jparams = jfm.full_model_init(jax.random.key(seed), jcfg)
    model = tfm.FullModel(cfg)
    model.load_state_dict(full_model_params_from_jax(jparams))
    return jparams, jcfg, model, cfg


def _window(seed, b=5, f=9, d=32, pad_from=6):
    rng = np.random.default_rng(seed)
    reps = rng.standard_normal((b, 1, f, d)).astype(np.float32)
    mask = np.zeros((b, 1, f + 1), bool)
    mask[1, 0, pad_from:] = True     # one window with padded frames
    return reps, mask


def test_temporal_encoder_and_attention_match_jax():
    from sais_tpu.models.temporal import encoder_forward as jax_encoder
    jparams, jcfg, model, cfg = _temporal_pair()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 10, 32)).astype(np.float32)
    mask = np.zeros((4, 10), bool)
    mask[2, 7:] = True
    ref_out, ref_attn = jax_encoder(jparams["frame_encoder"], jnp.asarray(x),
                                    jcfg.temporal, jnp.asarray(mask))
    with torch.no_grad():
        out, attn = encoder_forward(model.frame_encoder, torch.tensor(x),
                                    cfg.temporal, torch.tensor(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=1e-4)
    np.testing.assert_allclose(attn.numpy(), np.asarray(ref_attn), atol=1e-4)
    assert np.abs(attn.numpy()[2, :, 7:]).max() < 1e-30   # masked keys


@pytest.mark.parametrize("modalities", ["RGB", "RGB-Flow"])
def test_prototypes_forward_and_probs_match_jax(modalities):
    jparams, jcfg, model, cfg = _temporal_pair(seed=3, modalities=modalities)
    rgb, rgb_mask = _window(4)
    flow, flow_mask = _window(5, f=3, pad_from=2)
    protos = np.random.default_rng(6).random((2, 256)).astype(np.float32)
    ref = jfm.prototypes_forward(jparams, jcfg, jnp.asarray(rgb),
                                 jnp.asarray(rgb_mask), jnp.asarray(flow),
                                 jnp.asarray(flow_mask))
    ref_probs = jheads.prototype_probs(ref.video_rep, jnp.asarray(protos))
    with torch.no_grad():
        out = tfm.prototypes_forward(model, cfg, torch.tensor(rgb),
                                     torch.tensor(rgb_mask),
                                     torch.tensor(flow),
                                     torch.tensor(flow_mask))
        probs = theads.prototype_probs(out.video_rep, torch.tensor(protos))
    for got, want in ((out.video_rep, ref.video_rep),
                      (out.aux_logits, ref.aux_logits), (out.attn, ref.attn),
                      (probs, ref_probs)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(
        theads.entropy(probs).numpy(),
        np.asarray(jheads.entropy(ref_probs)), atol=1e-5)


def test_resolve_flash_never_takes_an_unported_kernel():
    """K2 is ported: auto takes it on the card at flash_min_len tokens and
    stays dense below it and off the card; forced values are honored."""
    cfg = ModelConfig(temporal=TemporalConfig(flash_min_len=16))
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert tfm.resolve_flash(cfg, 15, cuda) is False     # dense below
    assert tfm.resolve_flash(cfg, 16, cpu) is False      # dense off the card
    assert tfm.resolve_flash(cfg, 16, cuda) is True
    forced = ModelConfig(temporal=TemporalConfig(use_flash=True))
    assert tfm.resolve_flash(forced, 4, cpu) is True
    off = ModelConfig(temporal=TemporalConfig(use_flash=False,
                                              flash_min_len=16))
    assert tfm.resolve_flash(off, 600, cuda) is False


def test_reference_checkpoint_loads_like_jax():
    """A random reference fullModel state_dict (params.zip layout, with its
    importance_function) and a prototypes ParameterDict: the port's loaders
    against the JAX package's torch_port converters, same window
    probabilities and importance scores."""
    from sais_tpu.port.torch_port import (full_model_params_from_torch,
                                          prototypes_from_torch)
    from sais_tpu_torch.port.weights import (full_model_params_from_reference,
                                             prototypes_from_reference)
    from tests.golden.torch_temporal import random_full_model_state_dict

    gen = torch.Generator().manual_seed(0)
    sd = random_full_model_state_dict(gen, dim=32, proj=256, ffn=64,
                                      layers=2, pos_slots=16)
    sd = {f"module.{k}": v for k, v in sd.items()}
    protos = {"a": torch.rand(1, 256, generator=gen),
              "b": torch.rand(1, 256, generator=gen)}
    temporal = dict(TEMP, max_positions=16)
    jcfg = JModelConfig(rep_dim=32, modalities="RGB", importance_head=True,
                        temporal=JTemporalConfig(**temporal))
    cfg = ModelConfig(rep_dim=32, modalities="RGB", importance_head=True,
                      temporal=TemporalConfig(**temporal))
    model = tfm.FullModel(cfg)
    model.load_state_dict(full_model_params_from_reference(sd))
    keys, pmat = prototypes_from_reference(protos)
    jkeys, jpmat = prototypes_from_torch(protos)
    assert keys == jkeys == ["a", "b"]
    rgb, rgb_mask = _window(8, d=32)
    ref = jfm.prototypes_forward(full_model_params_from_torch(sd, 2), jcfg,
                                 jnp.asarray(rgb), jnp.asarray(rgb_mask))
    with torch.no_grad():
        out = tfm.prototypes_forward(model, cfg, torch.tensor(rgb),
                                     torch.tensor(rgb_mask))
        probs = theads.prototype_probs(out.video_rep, pmat)
    np.testing.assert_allclose(
        probs.numpy(), np.asarray(jheads.prototype_probs(ref.video_rep,
                                                         jpmat)), atol=1e-4)
    np.testing.assert_allclose(out.importances.numpy(),
                               np.asarray(ref.importances), atol=1e-4)
