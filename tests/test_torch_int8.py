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

from fractions import Fraction

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


# ---------------------------------------------------------------------------
# The card's algorithm (csrc/gemm_sm90.cuh: the int8 GEMM mode and K8's
# fused MLP, mlp_i8) emulated in PyTorch and held against the JAX kernel.
# ---------------------------------------------------------------------------

SLICE, HALF = 256, 128   # fc1 slices of 256 hidden columns, 128 a consumer


def mlp_quant_in_card_order(v, h):
    """K8's MLP order for v, the dequantized fc1 (rows, H) in f32, and h =
    gelu(v): pass 1 walks the slices and each consumer's 128 columns with a
    running row max A of |h|, which takes |h| at the half's largest v and
    then |h| only where |v| > A (no other value can raise it: |gelu(v)| <=
    |v|); the halves' maxima merge into the row scale; pass 2 quantizes
    each slice with it.  Returns (int8 h, the scales (rows, 1), the number
    of h values pass 1 read)."""
    rows, hidden = v.shape
    amax = torch.zeros(rows, 2)
    read = 0
    for j in range(hidden // SLICE):
        for c in range(2):
            cols = slice(j * SLICE + c * HALF, j * SLICE + (c + 1) * HALF)
            vs, hs = v[:, cols], h[:, cols]
            top = hs.gather(1, vs.argmax(1, keepdim=True))[:, 0].abs()
            a = torch.maximum(amax[:, c], top)
            cand = vs.abs() > a[:, None]
            read += rows + int(cand.sum())
            amax[:, c] = torch.maximum(
                a, torch.where(cand, hs.abs(), torch.zeros(())).amax(1))
    scale = torch.clamp(amax.amax(1, keepdim=True), min=1e-8) * tmha._INV127
    q = torch.cat([torch.clamp(torch.round(h[:, j * SLICE:(j + 1) * SLICE]
                                           / scale), -127, 127)
                   for j in range(hidden // SLICE)], 1).to(torch.int8)
    return q, scale, read


def test_mlp_order_gives_jax_quant_rows_bits():
    """The card's MLP order gives _quant_rows' int8 h and row scales bit for
    bit: v from JAX's _int8_mm of a quantized LN2 output (rows of ordinary,
    tiny and zero values), h = JAX's tanh GELU of it (elementwise, so
    slices of it are slices of the whole)."""
    rng = np.random.default_rng(4)
    d, hidden, rows = 64, 768, 40
    y = rng.standard_normal((rows, d)).astype(np.float32)
    y[3] *= 1e-3      # a row whose max |h| comes from a negative value
    y[7] = 0.0        # a row of biases only
    w = (0.05 * rng.standard_normal((d, hidden))).astype(np.float32)
    b = (0.05 * rng.standard_normal(hidden)).astype(np.float32)
    b[:SLICE] -= 0.3
    yq, ys = jmha._quant_rows(jnp.asarray(y))
    wq, ws = jmha.quantize_weight(jnp.asarray(w))
    v = yq.astype(jnp.int32) @ wq.astype(jnp.int32)
    v = v.astype(jnp.float32) * ys * ws + jnp.asarray(b)
    h = jax.nn.gelu(v, approximate=True)
    jq, js = jmha._quant_rows(h)
    tv, th = (torch.from_numpy(np.array(a)) for a in (v, h))
    assert bool((th.abs() <= tv.abs()).all())
    q, scale, read = mlp_quant_in_card_order(tv, th)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(js))
    assert read < rows * hidden // 4, read   # pass 1 reads few h values


def _block_in_card_order(x, ws, num_heads, valid_len, eps=1e-6):
    """K8 as the card runs it: the plain quantizers and products for qkv and
    proj; the MLP in mlp_i8's order, fc2's int32 products summed slice by
    slice (exact in int64)."""
    (qkv_w, qkv_b, proj_w, proj_b, fc1_w, fc1_b, fc2_w, fc2_b, ln1_s, ln1_b,
     ln2_s, ln2_b) = ws
    b, l, d = x.shape
    bf = torch.bfloat16
    yq, ys = tmha.quant_rows(tmha.layer_norm_f32(x, ln1_s, ln1_b, eps)
                             .reshape(-1, d))
    qkv = tmha.block_gemm_int8_reference(yq, ys, *tmha.quantize_weight(qkv_w),
                                         qkv_b, "bf16").reshape(b, l, 3 * d)
    ctx = tmha._attention_ctx(qkv, num_heads, valid_len)
    cq, cs = tmha.quant_rows(ctx.float().reshape(-1, d))
    x1 = tmha.block_gemm_int8_reference(cq, cs, *tmha.quantize_weight(proj_w),
                                        proj_b, "residual", x.reshape(-1, d))
    yq, ys = tmha.quant_rows(tmha.layer_norm_f32(x1, ln2_s, ln2_b, eps))
    w1q, w1s = tmha.quantize_weight(fc1_w)
    v = tmha._int8_mm(yq, ys, w1q, w1s, fc1_b)
    hq, hs, _ = mlp_quant_in_card_order(
        v, torch.nn.functional.gelu(v, approximate="tanh"))
    w2q, w2s = tmha.quantize_weight(fc2_w)
    acc = sum(hq[:, j:j + SLICE].long() @ w2q[j:j + SLICE].long()
              for j in range(0, hq.shape[1], SLICE))
    out = acc.float() * hs * w2s + fc2_b.float()
    return (x1 + out.to(bf)).reshape(b, l, d)


@pytest.mark.parametrize("valid", [L, 11])
def test_block_in_card_order_matches_pallas_kernel(valid):
    """The block in the card's order against fused_vit_block_int8
    (interpret=True) at two fc1 slices, within the block limit (2e-2 of
    the largest value)."""
    x, ws = _inputs(valid + 100, mlp=2 * SLICE)
    ref = jmha.fused_vit_block_int8(
        jnp.asarray(x, jnp.bfloat16), *[jnp.asarray(w, jnp.bfloat16)
                                        for w in ws],
        num_heads=HEADS, valid_len=valid, interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))[:, :valid]
    got = _block_in_card_order(_bf16(x), list(map(_bf16, ws)), HEADS, valid)
    got = got.float().numpy()[:, :valid]
    assert np.abs(got - ref).max() <= 2e-2 * np.abs(ref).max()


@pytest.mark.parametrize("m,k,n", [(37, 384, 192), (7, 1536, 384),
                                   (64, 96, 128)])
@pytest.mark.parametrize("epilogue", ["bf16", "residual"])
def test_int8_gemm_plain_version_matches_jnp(m, k, n, epilogue):
    """block_gemm_int8's plain version against jnp: the int32 products and
    the dequantized, bf16-rounded outputs bit for bit."""
    rng = np.random.default_rng(m + k + n)
    y = (2 * rng.standard_normal((m, k))).astype(np.float32)
    w = (0.05 * rng.standard_normal((k, n))).astype(np.float32)
    bias = _bf16(0.05 * rng.standard_normal(n).astype(np.float32))
    resid = _bf16(rng.standard_normal((m, n)).astype(np.float32))
    jq, js = jmha._quant_rows(jnp.asarray(y))
    jwq, jws = jmha.quantize_weight(jnp.asarray(w))
    acc = jax.lax.dot_general(jq, jwq, (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    q, qs = tmha.quant_rows(torch.tensor(y))
    wq, ws = tmha.quantize_weight(torch.tensor(w))
    np.testing.assert_array_equal(tmha.int8_products(q, wq).numpy(),
                                  np.asarray(acc))
    v = acc.astype(jnp.float32) * js * jws + jnp.asarray(bias.float().numpy())
    ref = v.astype(jnp.bfloat16)
    if epilogue == "residual":
        ref = jnp.asarray(resid.float().numpy(), jnp.bfloat16) + ref
    got = tmha.block_gemm_int8(q, qs, wq, ws, bias, epilogue,
                               resid if epilogue == "residual" else None)
    assert tmha.block_gemm_int8.launches == 0   # CPU: plain version
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


def _rn32(x):
    """The exact rational x rounded to the nearest float32, ties to even."""
    f = np.float32(float(x))
    cands = (np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf)))
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                     int(np.array(c).view(np.int32)) & 1))


def test_markstein_quotient_is_the_division():
    """The kernels' quantizer forms y / s as q0 = RN(y r), q = RN(q0 +
    RN(y - q0 s) r) with r = RN(1 / s) (gemm_sm90.cuh, quant_one); in
    exact arithmetic, over scales from quant_scale and values up to the
    row maximum (half-way cases included), that is y / s rounded to
    nearest, so its int8 are the division's."""
    rng = np.random.default_rng(11)
    amax = np.exp(rng.uniform(np.log(1e-6), np.log(1e4), 600))
    amax = np.concatenate([amax, [0.0, 1e-9, 127.0, 1.0]]).astype(np.float32)
    scales = np.maximum(amax, np.float32(1e-8)) * np.float32(1.0 / 127.0)
    checked = 0
    for s, a in zip(scales, amax):
        ys = rng.uniform(-1, 1, 6).astype(np.float32) * a
        halves = (np.arange(-3, 3) + 0.5).astype(np.float32) * s
        for y in np.concatenate([ys, halves, [a, -a, np.float32(0)]]):
            fy, fs = Fraction(float(y)), Fraction(float(s))
            r = _rn32(1 / fs)
            q0 = _rn32(fy * Fraction(float(r)))
            e = _rn32(fy - Fraction(float(q0)) * fs)
            q = _rn32(Fraction(float(q0)) + Fraction(float(e)) *
                      Fraction(float(r)))
            assert q == _rn32(fy / fs), (y, s)
            checked += 1
    assert checked > 9000
