"""K8 (the W8A8 ViT block) in the port against the JAX package: the
quantizers bitwise, the plain block against the Pallas kernel
`fused_vit_block_int8` in interpret mode, the fused encoder with
quant="int8" against the JAX composition, and the f32 path's warning.
The CUDA kernel is held against the plain version on the card in
tests/test_torch_cuda.py.

Limits: quantizers bitwise (the same f32 operations); the block 2e-2 of
the largest value (both round at the same points, but a LayerNorm or
softmax summed in another order may move a value across a quantizer's
rounding tie, one int8 step); cosine > 0.9999 against the bf16 block,
JAX's own limit (tests/test_int8_block.py)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sais_tpu.kernels import fused_mha as jmha
from sais_tpu.models import vit as jvit
from sais_tpu_torch.kernels import fused_mha as tmha
from sais_tpu_torch.models import vit as tvit

HEADS, D, L, B = 2, 64, 17, 3


def _inputs(seed, b=B, l=L, d=D, mlp=4 * D):
    rng = np.random.default_rng(seed)
    shapes = [(d, 3 * d), (3 * d,), (d, d), (d,), (d, mlp), (mlp,),
              (mlp, d), (d,), (d,), (d,), (d,), (d,)]
    ws = [0.05 * rng.standard_normal(s).astype(np.float32) for s in shapes]
    ws[8] += 1.0    # LN scales near 1
    ws[10] += 1.0
    return rng.standard_normal((b, l, d)).astype(np.float32), ws


def _bf16(a):
    return torch.tensor(a).bfloat16()


def test_quantizers_bitwise_equal_jax():
    rng = np.random.default_rng(0)
    w = (0.1 * rng.standard_normal((96, 160))).astype(np.float32)
    w[:, 3] = 0.0                               # an all-zero column
    w[5, 7] = 0.5 * (np.abs(w[:, 7]).max() + 1)  # a rounding half-way case
    for w_in in (w, np.asarray(_bf16(w).float())):
        jq, js = jmha.quantize_weight(jnp.asarray(w_in))
        tq, ts = tmha.quantize_weight(torch.tensor(w_in))
        assert tq.dtype == torch.int8 and tuple(ts.shape) == (1, 160)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    y = (3 * rng.standard_normal((40, 96))).astype(np.float32)
    y[2] = 0.0
    y[4, :2] = [127.0, 0.5]     # 0.5 / (127/127) is a tie: half to even
    jq, js = jmha._quant_rows(jnp.asarray(y))
    tq, ts = tmha.quant_rows(torch.tensor(y))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq[4, 1] == 0


@pytest.mark.parametrize("valid", [L, 11])
def test_plain_block_matches_pallas_kernel(valid):
    x, ws = _inputs(valid)
    ref = jmha.fused_vit_block_int8(
        jnp.asarray(x, jnp.bfloat16), *[jnp.asarray(w, jnp.bfloat16)
                                        for w in ws],
        num_heads=HEADS, valid_len=valid, interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))[:, :valid]
    got = tmha.fused_vit_block_int8(_bf16(x), *map(_bf16, ws),
                                    num_heads=HEADS, valid_len=valid)
    assert tmha.fused_vit_block_int8.launches == 0   # CPU: plain version
    got = got.float().numpy()[:, :valid]
    assert np.abs(got - ref).max() <= 2e-2 * np.abs(ref).max()
    bf = tmha.vit_block_reference(_bf16(x), *map(_bf16, ws),
                                  num_heads=HEADS, valid_len=valid)
    bf = bf.float().numpy()[:, :valid]
    cos = (got.ravel() @ bf.ravel()) / (np.linalg.norm(got)
                                        * np.linalg.norm(bf))
    assert cos > 0.9999, cos
    assert np.abs(got - bf).max() / np.abs(bf).max() < 0.02


def _tiny_vit(seed):
    from sais_tpu.config import ViTConfig as JViTConfig
    from sais_tpu_torch.config import ViTConfig
    from sais_tpu_torch.port.weights import vit_params_from_jax
    kw = dict(image_size=32, patch_size=16, embed_dim=D, depth=2,
              num_heads=HEADS)
    jcfg = JViTConfig(**kw)
    jparams = jvit.vit_init(jax.random.key(seed), jcfg)
    model = tvit.VisionTransformer(ViTConfig(**kw))
    model.load_state_dict(vit_params_from_jax(jparams))
    return jparams, jcfg, model


def test_fused_encoder_int8_matches_jax_composition():
    """Depth-2 tiny ViT, bf16: JAX's prepare_tokens + one
    fused_vit_block_int8 (interpret) a block + the final LayerNorm against
    the port's vit_forward_fused(quant="int8"), CLS features within 5e-2
    of the largest value (2 blocks of the block limit above)."""
    jparams, jcfg, model = _tiny_vit(0)
    images = np.random.default_rng(1).standard_normal(
        (4, 32, 32, 3)).astype(np.float32)
    p16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
    x = jvit.prepare_tokens(p16, jnp.asarray(images, jnp.bfloat16), jcfg)
    l = x.shape[1]
    for blk in p16["blocks"]:
        x = jmha.fused_vit_block_int8(
            x, blk["attn"]["qkv_w"], blk["attn"]["qkv_b"],
            blk["attn"]["proj_w"], blk["attn"]["proj_b"], blk["mlp"]["fc1_w"],
            blk["mlp"]["fc1_b"], blk["mlp"]["fc2_w"], blk["mlp"]["fc2_b"],
            blk["ln1_s"], blk["ln1_b"], blk["ln2_s"], blk["ln2_b"],
            num_heads=HEADS, valid_len=l, interpret=True)
    ref = jvit._layer_norm(x, p16["ln_s"], p16["ln_b"], jcfg.layernorm_eps)
    ref = np.asarray(ref[:, 0].astype(jnp.float32))
    model = model.to(torch.bfloat16).requires_grad_(False)
    got = tvit.vit_forward_fused(model, torch.tensor(images), quant="int8")
    assert got.dtype == torch.float32 and got.shape == (4, D)
    assert np.abs(got.numpy() - ref).max() <= 5e-2 * np.abs(ref).max()
    # vit_features takes the same path for a bf16 model
    torch.testing.assert_close(
        tvit.vit_features(model, torch.tensor(images), quant="int8"), got,
        rtol=0, atol=0)
    with pytest.raises(ValueError, match="quant"):
        tvit.vit_forward_fused(model, torch.tensor(images), quant="int4")


def test_vit_features_f32_warns_and_ignores_quant():
    model = _tiny_vit(2)[2].requires_grad_(False)
    images = torch.tensor(np.random.default_rng(3).standard_normal(
        (2, 32, 32, 3)).astype(np.float32))
    with pytest.warns(UserWarning, match="quant='int8' ignored"):
        got = tvit.vit_features(model, images, quant="int8")
    torch.testing.assert_close(got, tvit.vit_features(model, images),
                               rtol=0, atol=0)
