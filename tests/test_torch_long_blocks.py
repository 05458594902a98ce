"""The ViT-block kernels past 256 tokens (the patch-8 DINO ViTs: 785 tokens
at 224 px) in the port against the JAX package's Pallas kernels, run with
interpret=True on the CPU:

- the plain versions of K1, K4, K5, K6 and K8 at 785 and 257 tokens and at
  the JAX package's padded shape (800 rows, keys >= 785 masked);
- the card's key-tiled attention (wgmma kernels over 64 x 64 tiles)
  emulated in torch (forward: two sweeps over 64-key tiles, each lane's
  running max and sum merged over its quad, then p = exp(s - m) / l
  rounded to bf16 before the product with v; K6's backward: a query-row
  pass whose lanes keep (m, l, d = sum exp(s - m) dp) over 64-key tiles,
  saves (m, l, r = rowsum(dp p), lse = m + log l) and forms ctx and dq,
  then a key-column pass that forms p = exp(s - lse), ds, dk and dv from
  the saved statistics) inside the plain blocks, against the Pallas
  kernels at 785, 257, 769 (one past a tile boundary) and 1025 tokens (the
  card keeps the scores in the log2 domain and takes exp as ex2.approx,
  which moves p by f32 ulps; emulated here with torch.exp);
- the patch-8 backbone paths (`vit_features` on K1, the trainable fused
  path on K4-K6, `vit_forward_train`) against the JAX package's.

The same numpy-seeded inputs go to both sides.  Limits, as the files that
test these kernels at 197 tokens state them: float32 block output 1e-4;
float32 gradients rtol 2e-3 / atol 2e-4; bf16 2e-2 of the largest value
(an ulp or two of bf16 where the sums run in another order; for K8 one
int8 step at a quantizer tie), which is also the limit the card holds the
kernels to; the bf16 backbones' features 2e-2 and each parameter gradient
5e-2 of the largest value (two bf16 blocks and the patch embedding).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sais_tpu.kernels import fused_mha as jmha
from sais_tpu_torch.kernels import fused_mha as tmha

HEADS, D, MLP = 2, 128, 512
TILE = 64        # the key-tiled kernels' rows a consumer and keys a tile
LANES = 4        # lanes sharing a score row in a wgmma (or mma.sync)
                 # accumulator fragment

# (B, L, valid): the patch-8 global crop, the first length past the register
# kernels' 256, and the JAX package's padded rows with keys >= 785 masked
CASES = [(1, 785, 785), (2, 257, 257), (1, 800, 785)]
ATTN_NAMES = ("dx", "dqkv_w", "dqkv_b", "dproj_w", "dproj_b", "dln1_s",
              "dln1_b")
MLP_NAMES = ("dx1", "dfc1_w", "dfc1_b", "dfc2_w", "dfc2_b", "dln2_s",
             "dln2_b")


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
    dropped, as (B, L, 1) float32."""
    rng = np.random.default_rng(seed)
    keep = (rng.random((2, b)) < 0.7).astype(np.float32)
    keep[0, 0] = 0.0
    return [np.broadcast_to(k[:, None, None] / np.float32(0.9),
                            (b, l, 1)).astype(np.float32) for k in keep]


def _dtypes(dtype):
    return ((jnp.float32, torch.float32) if dtype == "float32"
            else (jnp.bfloat16, torch.bfloat16))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32)).astype(dtype)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _assert_close(got, ref, dtype, grads=False, name=""):
    got, ref = _np(got), _np(ref).reshape(_np(got).shape)
    if dtype == "float32":
        tol = dict(rtol=2e-3, atol=2e-4) if grads else dict(rtol=1e-4,
                                                             atol=1e-4)
        np.testing.assert_allclose(got, ref, err_msg=name, **tol)
    else:
        err, scale = np.abs(got - ref).max(), np.abs(ref).max()
        assert err <= 2e-2 * scale, (name, err, scale)


# ---------------------------------------------------------------------------
# The plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,l,valid", CASES)
def test_k1_plain_matches_pallas(b, l, valid, dtype):
    jd, td = _dtypes(dtype)
    ws = _weights(l)
    x = np.random.default_rng(0).standard_normal((b, l, D)).astype(
        np.float32)
    ref = jmha.fused_vit_block(_j(x, jd), *(_j(w, jd) for w in ws),
                               num_heads=HEADS, valid_len=valid,
                               interpret=True)
    got = tmha.fused_vit_block(_t(x, td), *(_t(w, td) for w in ws),
                               num_heads=HEADS, valid_len=valid)
    assert tmha.fused_vit_block.launches == 0   # CPU: the plain version
    _assert_close(got[:, :valid], np.asarray(
        jnp.asarray(ref, jnp.float32))[:, :valid], dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,l,valid", CASES)
def test_k4_plain_matches_pallas(b, l, valid, dtype):
    jd, td = _dtypes(dtype)
    ws = _weights(l + 1)
    x = np.random.default_rng(1).standard_normal((b, l, D)).astype(
        np.float32)
    s1, s2 = _scales(b, l, 2)
    out, x1 = jmha._fused_block_fwd_train(
        _j(x, jd), *(_j(w, jd) for w in ws), num_heads=HEADS,
        valid_len=valid, eps=1e-6, interpret=True, s1=_j(s1, jd),
        s2=_j(s2, jd))
    got_out, got_x1 = tmha.fused_block_fwd_train(
        _t(x, td), *(_t(w, td) for w in ws), num_heads=HEADS,
        valid_len=valid, s1=_t(s1, td), s2=_t(s2, td))
    _assert_close(got_x1[:, :valid], _np(x1)[:, :valid], dtype)
    _assert_close(got_out[:, :valid], _np(out)[:, :valid], dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,l,valid", CASES)
def test_k5_plain_matches_pallas(b, l, valid, dtype):
    jd, td = _dtypes(dtype)
    ws = _weights(l + 2)
    rng = np.random.default_rng(3)
    x1 = rng.standard_normal((b, l, D)).astype(np.float32)
    dout = rng.standard_normal((b, l, D)).astype(np.float32)
    s2 = _scales(b, l, 4)[1]
    mw = [ws[i] for i in (4, 5, 6, 7, 10, 11)]
    ref = jmha._fused_block_bwd_mlp(_j(x1, jd), _j(dout, jd),
                                    *(_j(w, jd) for w in mw), eps=1e-6,
                                    interpret=True, s2=_j(s2, jd))
    got = tmha.fused_block_bwd_mlp(_t(x1, td), _t(dout, td),
                                   *(_t(w, td) for w in mw), s2=_t(s2, td))
    for name, a, r in zip(MLP_NAMES, got, ref):
        _assert_close(a, r, dtype, grads=True, name=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,l,valid", CASES)
def test_k6_plain_matches_pallas(b, l, valid, dtype):
    jd, td = _dtypes(dtype)
    ws = _weights(l + 3)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((b, l, D)).astype(np.float32)
    dx1 = rng.standard_normal((b, l, D)).astype(np.float32)
    s1 = _scales(b, l, 6)[0]
    aw = [ws[i] for i in (0, 1, 2, 3, 8, 9)]
    ref = jmha._fused_block_bwd_attn(_j(x, jd), _j(dx1, jd),
                                     *(_j(w, jd) for w in aw),
                                     num_heads=HEADS, valid_len=valid,
                                     eps=1e-6, interpret=True,
                                     s1=_j(s1, jd))
    got = tmha.fused_block_bwd_attn(_t(x, td), _t(dx1, td),
                                    *(_t(w, td) for w in aw),
                                    num_heads=HEADS, valid_len=valid,
                                    s1=_t(s1, td))
    for name, a, r in zip(ATTN_NAMES, got, ref):
        _assert_close(a, r, dtype, grads=True, name=name)


@pytest.mark.parametrize("b,l,valid", CASES)
def test_k8_plain_matches_pallas(b, l, valid):
    ws = _weights(l + 4)
    x = np.random.default_rng(7).standard_normal((b, l, D)).astype(
        np.float32)
    ref = jmha.fused_vit_block_int8(
        _j(x, jnp.bfloat16), *(_j(w, jnp.bfloat16) for w in ws),
        num_heads=HEADS, valid_len=valid, interpret=True)
    got = tmha.fused_vit_block_int8(_t(x, torch.bfloat16),
                                    *(_t(w, torch.bfloat16) for w in ws),
                                    num_heads=HEADS, valid_len=valid)
    _assert_close(got[:, :valid], _np(ref)[:, :valid], "bfloat16")


# ---------------------------------------------------------------------------
# The card's key-tiled attention, emulated in torch
# ---------------------------------------------------------------------------

def _tiled_scores(qkv, num_heads, valid_len):
    """(q, k, v, s): q, k, v (B, H, L, dh) float32 and the masked f32
    scores (B, H, L, Lk) with the keys padded to a multiple of TILE, as the
    kernels see them: keys >= valid_len score -1e30, tile padding -inf."""
    b, l, d3 = qkv.shape
    dh = d3 // 3 // num_heads
    q, k, v = (t.float().transpose(1, 2) for t in
               qkv.reshape(b, l, 3, num_heads, dh).unbind(2))
    lk = -(-l // TILE) * TILE
    k = torch.nn.functional.pad(k, (0, 0, 0, lk - l))
    v = torch.nn.functional.pad(v, (0, 0, 0, lk - l))
    cols = torch.arange(lk)
    s = (q * dh ** -0.5) @ k.transpose(-1, -2) + torch.where(
        cols >= valid_len, tmha._NEG_INF, 0.0)
    s[..., cols >= l] = -torch.inf
    return q, k, v, s


def _lane_stats(s, chunk, dp=None):
    """Each row's (m, l[, r]) as the kernels form them: keys in chunks of
    `chunk` (a tile: 64 keys on the card), each lane's running max m and
    sum l of exp(s - m) (and d = sum exp(s - m) dp) over its own columns
    (column c of a chunk belongs to lane (c % 8) // 2), the chunk's values
    summed, then merged into the running ones; then the four lanes merged;
    r = d / l."""
    *lead, lk = s.shape
    shape = (*lead, lk // 8, LANES, 2)
    s_l = s.reshape(shape).transpose(-3, -2)          # (..., lane, n8, 2)
    m = torch.full((*lead, LANES), -torch.inf)
    lsum = torch.zeros((*lead, LANES))
    dsum = torch.zeros((*lead, LANES))
    dp_l = None if dp is None else dp.reshape(shape).transpose(-3, -2)
    per = chunk // 8
    for c0 in range(0, lk // 8, per):
        sc = s_l[..., c0:c0 + per, :].flatten(-2)
        mx = torch.maximum(m, sc.max(-1).values)
        ok = mx > -torch.inf
        alpha = torch.where(m > -torch.inf, torch.exp(m - mx), 0.0)
        pe = torch.exp(sc - mx[..., None])
        lsum = torch.where(ok, lsum * alpha + pe.sum(-1), lsum)
        if dp_l is not None:
            dc = dp_l[..., c0:c0 + per, :].flatten(-2)
            dsum = torch.where(ok, dsum * alpha + (pe * dc).sum(-1), dsum)
        m = torch.where(ok, mx, m)
    mq = m.max(-1, keepdim=True).values
    a = torch.where(m > -torch.inf, torch.exp(m - mq), 0.0)
    lq, dq = (lsum * a).sum(-1), (dsum * a).sum(-1)
    return mq[..., 0], lq, dq / lq


def emulated_long_attention(qkv, num_heads, valid_len):
    """long_attention_sm90_kernel in torch: sweep 1 over 64-key tiles for
    each row's (m, l), sweep 2 for p = exp(s - m) / l rounded to qkv's dtype
    and ctx += pb v accumulated in f32 tile by tile, ctx rounded once (each
    64-query tile alone: the card's grouping of query tiles into units
    changes which block runs them, not what they compute)."""
    b, l, d3 = qkv.shape
    q, k, v, s = _tiled_scores(qkv, num_heads, valid_len)
    m, lsum, _ = _lane_stats(s, TILE)
    ctx = torch.zeros(q.shape)
    for k0 in range(0, s.shape[-1], TILE):
        p = torch.exp(s[..., k0:k0 + TILE] - m[..., None]) / lsum[..., None]
        ctx += p.to(qkv.dtype).float() @ v[..., k0:k0 + TILE, :]
    return ctx.transpose(1, 2).reshape(b, l, d3 // 3).to(qkv.dtype)


def emulated_long_attention_bwd(qkv, dctx, num_heads, valid_len):
    """K6's key-tiled attention backward in torch.  The query-row pass:
    (m, l, r) from 64-key tiles per lane, then per 64-key tile p, pb, ds =
    bf16(p (dp - r)), ctx += pb v and dq += ds k in f32.  The key-column
    pass: s^T and dp^T again, p = exp(s - lse) and ds from the saved (r,
    lse = m + log l), dv += pb^T dctx and dk += ds^T q per 64-query tile.
    Returns (ctx, dqkv) as `fused_mha._attention_bwd` does."""
    b, l, d3 = qkv.shape
    dtype = qkv.dtype
    dh = d3 // 3 // num_heads
    scale = dh ** -0.5
    q, k, v, s = _tiled_scores(qkv, num_heads, valid_len)
    dc = dctx.float().reshape(b, l, num_heads, dh).transpose(1, 2)
    dp = dc @ v.transpose(-1, -2)
    m, lsum, r = _lane_stats(s, TILE, dp)        # saved with lse
    lse = m + torch.log(lsum)
    ctx, dq = torch.zeros(q.shape), torch.zeros(q.shape)
    for k0 in range(0, s.shape[-1], TILE):
        sl = slice(k0, k0 + TILE)
        p = torch.exp(s[..., sl] - m[..., None]) / lsum[..., None]
        ds = (p * (dp[..., sl] - r[..., None])).to(dtype).float()
        ctx += p.to(dtype).float() @ v[..., sl, :]
        dq += ds @ k[..., sl, :]
    # key-column pass, from the saved statistics
    dk, dv = torch.zeros(k.shape), torch.zeros(v.shape)
    for q0 in range(0, l, TILE):
        sl = slice(q0, q0 + TILE)
        st = s[..., sl, :].transpose(-1, -2)        # (B, H, keys, queries)
        dpt = dp[..., sl, :].transpose(-1, -2)
        p = torch.exp(st - lse[..., None, sl])
        ds = (p * (dpt - r[..., None, sl])).to(dtype).float()
        dv += p.to(dtype).float() @ dc[..., sl, :]
        dk += ds @ q[..., sl, :]
    dqkv = torch.stack([dq * scale, dk[..., :l, :] * scale, dv[..., :l, :]],
                       2)                       # (B, H, 3, L, dh)
    dqkv = dqkv.permute(0, 3, 2, 1, 4).reshape(b, l, d3).to(dtype)
    return ctx.transpose(1, 2).reshape(b, l, d3 // 3).to(dtype), dqkv


EMULATED = [(1, 785, 785), (2, 257, 257), (1, 769, 769), (1, 1025, 1025),
            (1, 800, 785)]


@pytest.mark.parametrize("b,l,valid", EMULATED)
def test_emulated_tiled_forward_matches_pallas(b, l, valid, monkeypatch):
    """K1 and K4 with the card's key-tiled attention, bf16, against the
    Pallas kernels, at the card's limit; the emulated attention alone
    against the plain one at 2e-2 of the largest value too."""
    ws = _weights(l + 5)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((b, l, D)).astype(np.float32)
    bf = torch.bfloat16
    qkv = _t(rng.standard_normal((b, l, 3 * D)), bf)
    _assert_close(emulated_long_attention(qkv, HEADS, valid)[:, :valid],
                  tmha._attention_ctx(qkv, HEADS, valid)[:, :valid],
                  "bfloat16")
    monkeypatch.setattr(tmha, "_attention_ctx", emulated_long_attention)
    ref = jmha.fused_vit_block(_j(x, jnp.bfloat16),
                               *(_j(w, jnp.bfloat16) for w in ws),
                               num_heads=HEADS, valid_len=valid,
                               interpret=True)
    got = tmha.vit_block_reference(_t(x, bf), *(_t(w, bf) for w in ws),
                                   num_heads=HEADS, valid_len=valid)
    _assert_close(got[:, :valid], _np(ref)[:, :valid], "bfloat16")
    s1, s2 = _scales(b, l, 9)
    out, x1 = jmha._fused_block_fwd_train(
        _j(x, jnp.bfloat16), *(_j(w, jnp.bfloat16) for w in ws),
        num_heads=HEADS, valid_len=valid, eps=1e-6, interpret=True,
        s1=_j(s1, jnp.bfloat16), s2=_j(s2, jnp.bfloat16))
    got_out, got_x1 = tmha.vit_block_train_reference(
        _t(x, bf), *(_t(w, bf) for w in ws), num_heads=HEADS,
        valid_len=valid, s1=_t(s1, bf), s2=_t(s2, bf))
    _assert_close(got_x1[:, :valid], _np(x1)[:, :valid], "bfloat16")
    _assert_close(got_out[:, :valid], _np(out)[:, :valid], "bfloat16")


@pytest.mark.parametrize("b,l,valid", EMULATED)
def test_emulated_tiled_backward_matches_pallas(b, l, valid, monkeypatch):
    """K6 with the card's two-pass key-tiled attention backward (saved m,
    l and r = rowsum(dp p) from the f32 p), bf16, against
    `_fused_block_bwd_attn(interpret=True)` at the card's limit."""
    ws = _weights(l + 6)
    rng = np.random.default_rng(10)
    x = rng.standard_normal((b, l, D)).astype(np.float32)
    dx1 = rng.standard_normal((b, l, D)).astype(np.float32)
    s1 = _scales(b, l, 11)[0]
    aw = [ws[i] for i in (0, 1, 2, 3, 8, 9)]
    bf = torch.bfloat16
    monkeypatch.setattr(tmha, "_attention_bwd", emulated_long_attention_bwd)
    ref = jmha._fused_block_bwd_attn(
        _j(x, jnp.bfloat16), _j(dx1, jnp.bfloat16),
        *(_j(w, jnp.bfloat16) for w in aw), num_heads=HEADS,
        valid_len=valid, eps=1e-6, interpret=True, s1=_j(s1, jnp.bfloat16))
    got = tmha.block_bwd_attn_reference(_t(x, bf), _t(dx1, bf),
                                        *(_t(w, bf) for w in aw),
                                        num_heads=HEADS, valid_len=valid,
                                        s1=_t(s1, bf))
    for name, a, r in zip(ATTN_NAMES, got, ref):
        _assert_close(a, r, "bfloat16", grads=True, name=name)


def test_emulated_statistics_equal_softmax():
    """The lane-wise running (m, l, r) of `_lane_stats`, merged, equal the
    row max, the softmax sum and rowsum(dp p) of the whole row in float64
    terms: the online rescaling changes f32 rounding only; and the key-column
    pass's p = exp(s - lse), lse = m + log l, is the normalised softmax."""
    rng = np.random.default_rng(12)
    qkv = _t(rng.standard_normal((1, 300, 3 * D)))
    _, _, v, s = _tiled_scores(qkv, HEADS, 290)
    dp = torch.from_numpy(rng.standard_normal(s.shape).astype(np.float32))
    for chunk in (16, TILE):
        m, lsum, r = _lane_stats(s, chunk, dp)
        s64 = s.double()
        m_ref = s64.max(-1).values
        p = torch.exp(s64 - m_ref[..., None])
        np.testing.assert_array_equal(m.numpy(), m_ref.float().numpy())
        np.testing.assert_allclose(lsum.numpy(), p.sum(-1).numpy(),
                                   rtol=1e-5)
        p = p / p.sum(-1, keepdim=True)
        np.testing.assert_allclose(r.numpy(), (p * dp.double()).sum(
            -1).numpy(), rtol=1e-4, atol=1e-5)
        p_lse = torch.exp(s - (m + torch.log(lsum))[..., None])
        np.testing.assert_allclose(p_lse.numpy(), p.numpy(), rtol=1e-5,
                                   atol=1e-7)


# ---------------------------------------------------------------------------
# The patch-8 backbone, trainer and command
# ---------------------------------------------------------------------------

def _tiny_vit8(seed, depth=2):
    """A patch-8 ViT at 224 px (785 tokens) of this file's widths, from the
    JAX init moved by 0.02 noise (non-trivial LayerNorms and biases), in
    both packages."""
    from sais_tpu.config import ViTConfig as JViTConfig
    from sais_tpu.models.vit import vit_init as jax_vit_init
    from sais_tpu_torch.config import ViTConfig
    from sais_tpu_torch.models.vit import VisionTransformer
    from sais_tpu_torch.port.weights import vit_params_from_jax
    kw = dict(image_size=224, patch_size=8, embed_dim=D, depth=depth,
              num_heads=HEADS)
    jcfg = JViTConfig(**kw)
    params = jax_vit_init(jax.random.key(seed), jcfg)
    params = jax.tree.map(
        lambda a: a + 0.02 * jax.random.normal(jax.random.key(a.size),
                                               a.shape), params)
    model = VisionTransformer(ViTConfig(**kw))
    model.load_state_dict(vit_params_from_jax(jax.tree.map(np.asarray,
                                                           params)))
    return params, jcfg, model


@pytest.mark.parametrize("size", [224, 96])
def test_patch8_vit_features_match_jax_fused_blocks(size):
    """`vit_features` of a bf16 patch-8 model (every block one K1 call, its
    plain version here) against the JAX package's fused composition: its
    prepare_tokens (the positional table interpolated to 12 x 12 at 96
    px), rows padded to a multiple of 16 with the padding masked, one
    `fused_vit_block(interpret=True)` a block and the final LayerNorm."""
    from sais_tpu.models import vit as jvit
    from sais_tpu_torch.models.vit import vit_features
    params, jcfg, model = _tiny_vit8(0)
    images = np.random.default_rng(1).standard_normal(
        (2, size, size, 3)).astype(np.float32)
    p16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
    x = jvit.prepare_tokens(p16, _j(images, jnp.bfloat16), jcfg)
    l = x.shape[1]
    assert l == (size // 8) ** 2 + 1
    lp = l + (-l) % 16
    x = jnp.pad(x, ((0, 0), (0, lp - l), (0, 0)))
    for blk in p16["blocks"]:
        x = jmha.fused_vit_block(
            x, blk["attn"]["qkv_w"], blk["attn"]["qkv_b"],
            blk["attn"]["proj_w"], blk["attn"]["proj_b"], blk["mlp"]["fc1_w"],
            blk["mlp"]["fc1_b"], blk["mlp"]["fc2_w"], blk["mlp"]["fc2_b"],
            blk["ln1_s"], blk["ln1_b"], blk["ln2_s"], blk["ln2_b"],
            num_heads=HEADS, valid_len=l, interpret=True)
    ref = jvit._layer_norm(x[:, :l], p16["ln_s"], p16["ln_b"],
                           jcfg.layernorm_eps)
    ref = _np(ref[:, 0])
    model = model.to(torch.bfloat16).requires_grad_(False)
    got = vit_features(model, _t(images))
    assert got.dtype == torch.float32 and got.shape == (2, D)
    assert np.abs(_np(got) - ref).max() <= 2e-2 * np.abs(ref).max()


def test_patch8_trainable_fused_backbone_matches_jax():
    """`vit_features_trainable_fused` (K4 forward, K5 and K6 backward, their
    plain versions here) of a patch-8 model at 224 px, with JAX's drop-path
    draws injected: CLS features and every parameter gradient against the
    JAX package's fused training path (Pallas kernels in interpret mode,
    rows padded to 800 with the padding masked)."""
    from sais_tpu.models.vit import drop_path_scales as jax_scales
    from sais_tpu.models.vit import vit_features_trainable_fused as jax_fused
    from sais_tpu_torch.models.vit import vit_features_trainable_fused
    from sais_tpu_torch.port.weights import vit_params_from_jax
    params, jcfg, model = _tiny_vit8(2)
    b, rate, key = 3, 0.5, jax.random.key(5)
    images = np.random.default_rng(3).standard_normal(
        (b, 224, 224, 3)).astype(np.float32)
    cot = np.random.default_rng(4).standard_normal((b, D)).astype(np.float32)

    def loss(p):
        f = jax_fused(p, _j(images), jcfg, interpret=True,
                      drop_path_rate=rate, rng=key)
        return jnp.sum(f * _j(cot)), f

    (_, feats), grads = jax.value_and_grad(loss, has_aux=True)(params)
    rngs = jax.random.split(key, 2 * jcfg.depth)
    scales = []
    for i in range(jcfg.depth):
        keep = 1.0 - rate * i / max(jcfg.depth - 1, 1)
        scales.append(tuple(
            _t(np.asarray(jax_scales(rngs[2 * i + j], keep, b)
                          .astype(jnp.bfloat16), np.float32))
            for j in range(2)))
    assert any((s == 0).any() for pair in scales for s in pair)
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


def test_patch8_forward_train_matches_jax_vit_forward():
    """`vit_forward_train` (the plain bf16 training path) of a patch-8 model
    at 224 px against the JAX package's `vit_forward` at compute dtype
    bf16, its counterpart: CLS features and every parameter gradient."""
    from sais_tpu.models.vit import vit_forward as jax_forward
    from sais_tpu_torch.models.vit import vit_forward_train
    from sais_tpu_torch.port.weights import vit_params_from_jax
    params, jcfg, model = _tiny_vit8(6)
    images = np.random.default_rng(7).standard_normal(
        (2, 224, 224, 3)).astype(np.float32)
    cot = np.random.default_rng(8).standard_normal((2, D)).astype(np.float32)

    def loss(p):
        f = jax_forward(p, _j(images), jcfg, compute_dtype=jnp.bfloat16)[0]
        return jnp.sum(f * _j(cot)), f

    (_, feats), grads = jax.value_and_grad(loss, has_aux=True)(params)
    got = vit_forward_train(model, _t(images))
    (got * _t(cot)).sum().backward()
    f_ref = _np(feats)
    assert np.abs(_np(got) - f_ref).max() <= 2e-2 * np.abs(f_ref).max()
    ref_grads = vit_params_from_jax(jax.tree.map(
        lambda a: np.asarray(a, np.float32), grads))
    for name, p in model.named_parameters():
        r = ref_grads[name].numpy()
        err = np.abs(p.grad.numpy() - r).max()
        assert err <= 5e-2 * np.abs(r).max(), (name, err, np.abs(r).max())


def test_trainer_steps_match_jax_patch8():
    """Two DINOTrainer steps on a patch-8 geometry (global crops at 224 px,
    785 tokens; locals at 96 px, 145 tokens; sgd, no drop path) against
    the JAX DINOTrainer(fused_blocks=False, fused_loss=False) from the same
    weights and crops, at tests/test_torch_dino.py's limits: losses 2e-3
    relative, the center and every parameter 1e-3 of the largest value.
    As there, the lr keeps every update within about 1% of the weights
    (XLA and PyTorch round bf16 at other places, which moves a gradient by
    up to a few percent where its rows cancel: here the v bias, summed
    over 3,140 rows a step)."""
    from sais_tpu.config import ViTConfig as JViTConfig
    from sais_tpu.train import dino as jdino
    from sais_tpu_torch.config import ViTConfig
    from sais_tpu_torch.port.weights import dino_state_from_jax
    from sais_tpu_torch.train import dino as tdino
    kw = dict(image_size=224, patch_size=8, embed_dim=64, depth=1,
              num_heads=1)
    b = 2
    base = dict(out_dim=128, batch_size=b, n_local_crops=2, global_size=224,
                local_size=96, epochs=1, warmup_epochs=0,
                freeze_last_layer_epochs=0, drop_path_rate=0.0,
                weight_decay=0.04, weight_decay_end=0.1, lr=2.5e-4 * 256 / b)
    jcfg, tcfg = jdino.DINOConfig(**base), tdino.DINOConfig(**base)
    jt = jdino.DINOTrainer(JViTConfig(**kw), jcfg, 2, jax.random.key(0),
                           optimizer="sgd", fused_blocks=False,
                           fused_loss=False)
    jt.student = jax.tree.map(
        lambda a: a + 0.02 * jax.random.normal(jax.random.key(a.size),
                                               a.shape), jt.student)
    jt.teacher = jax.tree.map(jnp.copy, jt.student)
    state = jax.tree.map(np.asarray, jt.state())
    state["center"] = np.random.default_rng(9).standard_normal(
        128).astype(np.float32) * 0.1
    jt.center = jnp.asarray(state["center"])
    tt = tdino.DINOTrainer(ViTConfig(**kw), tcfg, 2,
                           torch.Generator().manual_seed(0), optimizer="sgd",
                           device="cpu", fused_blocks=False)
    sd = dino_state_from_jax(state)
    tt.student.load_state_dict(sd["student"])
    tt.teacher.load_state_dict(sd["teacher"])
    tt.center = sd["center"]
    assert tuple(tt.student["backbone"].pos_embed.shape) == (1, 785, 64)
    for step in range(2):
        rng = np.random.default_rng(step)
        g = rng.standard_normal((2 * b, 224, 224, 3)).astype(np.float32)
        l = rng.standard_normal((2 * b, 96, 96, 3)).astype(np.float32)
        ref = jt.step(jnp.asarray(g), jnp.asarray(l))
        got = tt.step(_t(g), _t(l))
        assert abs(got - ref) <= 2e-3 * abs(ref), (step, got, ref)
    ref_c = _np(jt.center)
    assert np.abs(_np(tt.center) - ref_c).max() <= 1e-3 * np.abs(ref_c).max()
    ref_sd = dino_state_from_jax(jax.tree.map(np.asarray, jt.state()))
    for n, p in tt.student.named_parameters():
        r = ref_sd["student"][n].numpy()
        err = np.abs(p.detach().numpy() - r).max()
        assert err <= 1e-3 * np.abs(r).max(), (n, err)


def test_cli_pretrain_vits8_on_cpu(tmp_path, monkeypatch):
    """`pretrain --arch vits8 --device cpu` end to end on a synthetic mp4:
    the zoo's vits8 entry narrowed to a depth-1 width-64 patch-8 ViT, so
    the 224 px globals keep their 785 tokens and the 96 px locals their
    145; one epoch writes a checkpoint whose positional table has 785
    rows and a finite loss in the log."""
    import json
    import os

    import cv2

    from sais_tpu_torch.cli import main as cli
    from sais_tpu_torch.config import ViTConfig
    from sais_tpu_torch.models import zoo
    os.makedirs(tmp_path / "videos")
    writer = cv2.VideoWriter(str(tmp_path / "videos" / "v.mp4"),
                             cv2.VideoWriter_fourcc(*"mp4v"), 30, (80, 64))
    rng = np.random.default_rng(3)
    for _ in range(8):
        writer.write(rng.integers(0, 255, (64, 80, 3), dtype=np.uint8))
    writer.release()
    monkeypatch.setitem(zoo.CONFIGS, "vits8", ViTConfig(
        image_size=224, patch_size=8, embed_dim=64, depth=1, num_heads=1))
    cli.main(["pretrain", "-p", str(tmp_path), "--arch", "vits8", "-bs", "4",
              "-e", "1", "--out-dim", "32", "--local-crops", "2",
              "--device", "cpu", "--loader-threads", "1"])
    out = tmp_path / "pretrain"
    rec = json.loads((out / "log.txt").read_text().strip().splitlines()[-1])
    assert rec["epoch"] == 0 and np.isfinite(rec["train_loss"])
    state = torch.load(out / "ckpt" / "1.pt", weights_only=False)
    pos = state["student"]["backbone.pos_embed"]
    assert tuple(pos.shape) == (1, 785, 64)
