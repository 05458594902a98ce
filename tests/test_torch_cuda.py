"""The port's CUDA kernels on the card, against their plain PyTorch
versions.  Every test here needs a CUDA device and skips without one.

This file imports neither jax nor the JAX package, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import dataclasses
import math

import pytest
import torch

from chip_smoke import k7_inputs
from sais_tpu_torch.config import (ModelConfig, TemporalConfig, TrainConfig,
                                   ViTConfig)
from sais_tpu_torch.kernels.flash_attention import (
    FlashAttention, PackedFlashAttention, flash_attention,
    flash_attention_bwd, flash_attention_bwd_reference, flash_attention_fwd,
    flash_attention_packed, flash_attention_reference, key_bias, split_heads)
from sais_tpu_torch.kernels.fused_mha import (fused_vit_block,
                                              vit_block_reference)
from sais_tpu_torch.models.full_model import (full_model_init,
                                              prototypes_forward,
                                              prototypes_init)
from sais_tpu_torch.models.heads import prototype_probs
from sais_tpu_torch.models.vit import vit_forward_fused, vit_init

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(seed, b, l, d=384, mlp=1536, device="cuda"):
    g = torch.Generator().manual_seed(seed)
    shapes = [(d, 3 * d), (3 * d,), (d, d), (d,), (d, mlp), (mlp,),
              (mlp, d), (d,), (d,), (d,), (d,), (d,)]
    ws = [0.05 * torch.randn(s, generator=g) for s in shapes]
    ws[8] += 1.0    # LN scales near 1
    ws[10] += 1.0
    x = torch.randn((b, l, d), generator=g)
    kw = dict(device=device, dtype=torch.bfloat16)
    return x.to(**kw), [w.to(**kw) for w in ws]


@pytest.mark.parametrize("b,l,valid", [(8, 197, 197), (8, 208, 197),
                                       (3, 50, 13), (2, 256, 256),
                                       (5, 1, 1), (3, 197, 197),
                                       (5, 37, 37)])
def test_kernel_matches_plain_version(cuda, b, l, valid):
    """ViT-S widths (D=384, 6 heads, MLP 1536), bf16.  Limit: 2e-2 of the
    largest reference value, a few bf16 ulps (summation order differs)."""
    x, ws = _inputs(l, b, l)
    kw = dict(num_heads=6, valid_len=valid)
    before = fused_vit_block.launches
    out = fused_vit_block(x, *ws, **kw).float()
    torch.cuda.synchronize()
    assert fused_vit_block.launches == before + 1
    ref = vit_block_reference(x, *ws, **kw).float()
    err = (out[:, :valid] - ref[:, :valid]).abs().max().item()
    assert err <= 2e-2 * ref[:, :valid].abs().max().item(), err


def test_kernel_rejects_what_it_does_not_take(cuda):
    x, ws = _inputs(0, 2, 20)
    kw = dict(num_heads=6, valid_len=20)
    with pytest.raises(ValueError, match="bf16"):
        fused_vit_block(x.float(), *ws, **kw)
    with pytest.raises(ValueError, match="head dim"):
        fused_vit_block(x, *ws, num_heads=4, valid_len=20)
    with pytest.raises(ValueError, match="contiguous"):
        fused_vit_block(x.transpose(0, 1).contiguous().transpose(0, 1),
                        *ws, **kw)
    with pytest.raises(ValueError, match="valid_len"):
        fused_vit_block(x, *ws, num_heads=6, valid_len=21)
    with pytest.raises(ValueError, match="sequence length"):
        fused_vit_block(x[:, :0], *ws, num_heads=6, valid_len=1)


# (N, K) of the blocks' products at ViT-S widths: the forward's qkv, proj,
# fc1, fc2, one N that leaves a partial column tile, and K6's dy (N 384,
# K 1152).  Modes that read the weight transposed ("none", "dgelu", "f32")
# take it (N, K): K5's dh (1536, 384), dy (384, 1536), K6's dctx (384,
# 384), dy (384, 1152).  "wgrad" takes a (M, K) and w (M, N) and returns
# (K, N) over the M rows: dWqkv (384 x 1152), dWproj (384 x 384), dW1
# (384 x 1536), dW2 (1536 x 384), a partial tile (384 x 320).  M: the K1
# main path's 256 x 197 rows, ragged counts, the ViT-S/16 pretrain step's
# (512, 37) and (128, 197) groups, and the vits8 step's (128, 785) globals
# and (512, 145) locals.
GEMM_NK = [(1152, 384), (384, 384), (1536, 384), (384, 1536), (320, 384),
           (384, 1152)]
GEMM_M = [50432, 591, 18944, 7, 25216, 100480, 74240]


@pytest.mark.parametrize("epilogue,scaled", [("bias", False),
                                             ("gelu", False),
                                             ("residual", False),
                                             ("residual", True),
                                             ("none", False),
                                             ("gelu_save", False),
                                             ("dgelu", False),
                                             ("f32", False),
                                             ("wgrad", False)])
@pytest.mark.parametrize("m", GEMM_M)
@pytest.mark.parametrize("n,k", GEMM_NK)
def test_block_gemm_matches_torch(cuda, n, k, m, epilogue, scaled):
    """The wgmma + TMA GEMM of K1, K4, K5 and K6 alone against torch on
    the same bf16 inputs (f32 product, the same epilogue; the row scale
    holds zeros and 1/keep).  Limit: 2e-2 of the largest reference value,
    as for K1: both round at the same points and sum in another order."""
    from sais_tpu_torch.kernels.fused_mha import (block_gemm,
                                                  block_gemm_reference)
    g = torch.Generator().manual_seed(m + n + k)
    bf = dict(device=cuda, dtype=torch.bfloat16)
    a = torch.randn((m, k), generator=g).to(**bf)
    w_shape = {"none": (n, k), "dgelu": (n, k), "f32": (n, k),
               "wgrad": (m, n)}.get(epilogue, (k, n))
    w = (0.05 * torch.randn(w_shape, generator=g)).to(**bf)
    bias = residual = row_scale = aux = None
    if epilogue in ("bias", "gelu", "residual", "gelu_save"):
        bias = (0.05 * torch.randn((n,), generator=g)).to(**bf)
    if epilogue == "residual":
        residual = torch.randn((m, n), generator=g).to(**bf)
    if epilogue == "dgelu":
        aux = torch.randn((m, n), generator=g).to(**bf)
    if scaled:
        keep = (torch.rand((m,), generator=g) < 0.75).float()
        keep[0] = 0.0
        row_scale = (keep / 0.9).to(**bf)
    before = block_gemm.launches
    out = block_gemm(a, w, bias, epilogue, residual, row_scale, aux)
    torch.cuda.synchronize()
    assert block_gemm.launches == before + 1
    ref = block_gemm_reference(
        a, w, bias, epilogue, residual,
        None if row_scale is None else row_scale[:, None], aux)
    pairs = zip(out, ref) if epilogue == "gelu_save" else [(out, ref)]
    f32 = epilogue in ("f32", "wgrad")
    for got, want in pairs:
        assert got.shape == ((k, n) if epilogue == "wgrad" else (m, n))
        assert got.dtype == (torch.float32 if f32 else torch.bfloat16)
        _close(got, want, f"{epilogue} M={m} N={n} K={k}")


def test_block_gemm_rejects_what_it_does_not_take(cuda):
    from sais_tpu_torch.kernels.fused_mha import block_gemm
    bf = dict(device=cuda, dtype=torch.bfloat16)
    a, w, b = (torch.zeros(s, **bf) for s in ((7, 64), (64, 128), (128,)))
    with pytest.raises(ValueError, match="multiples"):
        block_gemm(a, torch.zeros((64, 96), **bf), b[:96], "bias")
    with pytest.raises(ValueError, match="bf16"):
        block_gemm(a.float(), w, b, "bias")
    with pytest.raises(ValueError, match="aligned"):
        block_gemm(torch.zeros(7 * 64 + 1, **bf)[1:].view(7, 64), w, b,
                   "bias")
    with pytest.raises(ValueError, match="shape"):
        block_gemm(a, w, None, "f32")   # "f32" reads w as (N, K)
    with pytest.raises(ValueError, match="multiples"):
        block_gemm(torch.zeros((7, 96), **bf), torch.zeros((7, 128), **bf),
                   None, "wgrad")


def test_vit_fused_path_on_kernel_matches_plain(cuda, monkeypatch):
    """A full-width ViT-S/16 (depth cut to 4) through K1 and through its
    plain version: CLS features within 5e-2 of the largest value."""
    from sais_tpu_torch.models import vit
    cfg = ViTConfig(depth=4)
    model = vit_init(torch.Generator().manual_seed(0), cfg).to(
        cuda, torch.bfloat16)
    images = torch.randn((16, 224, 224, 3),
                         generator=torch.Generator().manual_seed(1)).to(cuda)
    before = fused_vit_block.launches
    with torch.inference_mode():
        got = vit_forward_fused(model, images)
        monkeypatch.setattr(vit, "fused_vit_block", vit_block_reference)
        ref = vit_forward_fused(model, images)
    assert fused_vit_block.launches == before + cfg.depth
    assert got.shape == (16, 384) and torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= 5e-2 * ref.abs().max().item()


def _qkv(seed, b, h, lq, lk, dh, device="cuda"):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((b, h, lq, dh), generator=g).to(device),
            torch.randn((b, h, lk, dh), generator=g).to(device),
            torch.randn((b, h, lk, dh), generator=g).to(device))


def _ragged_mask(b, l, device="cuda"):
    """Masked tails that differ per element; the last element has every
    key masked."""
    mask = torch.zeros((b, l), dtype=torch.bool)
    for i in range(b):
        mask[i, l - 11 * i:] = True
    mask[-1] = True
    return mask.to(device)


@pytest.mark.parametrize("b,h,lq,lk,dh", [(3, 4, 301, 301, 96),
                                          (4, 2, 37, 37, 64),
                                          (2, 4, 130, 130, 128),
                                          (3, 1, 70, 200, 96),
                                          (2, 3, 1, 65, 64),
                                          (2, 2, 65, 129, 128),
                                          (2, 4, 2001, 2001, 96),
                                          (3, 2, 97, 161, 192),
                                          (2, 3, 161, 33, 192),
                                          (3, 4, 129, 129, 192),
                                          (2, 2, 257, 95, 128),
                                          (2, 4, 2001, 2001, 192)])
def test_flash_kernel_matches_plain_version(cuda, b, h, lq, lk, dh):
    """K2 against its plain version: out within 1e-4 of the largest plain
    value, lse within 1e-4 of max(1, |lse|) on elements with a valid key
    (both f32; summation order and the online rescaling differ by a few
    ulps); the all-masked element gives zeros and lse -1e30 on both."""
    q, k, v = _qkv(lq + lk, b, h, lq, lk, dh)
    bias = key_bias(_ragged_mask(b, lk))
    before = flash_attention.launches
    out, lse = flash_attention_fwd(q, k, v, bias)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref, ref_lse = flash_attention_reference(q, k, v, bias)
    ok = slice(0, b - 1)
    err = (out[ok] - ref[ok]).abs().max().item()
    assert err <= 1e-4 * ref[ok].abs().max().item(), err
    lerr = (lse[ok] - ref_lse[ok]).abs().max().item()
    assert lerr <= 1e-4 * max(1.0, ref_lse[ok].abs().max().item()), lerr
    assert (lse[-1] == -1e30).all() and (ref_lse[-1] == -1e30).all()
    if lq == lk:
        zeroed = flash_attention(q, k, v, bias < 0)
        assert torch.count_nonzero(zeroed[-1]) == 0
        torch.testing.assert_close(zeroed[ok], out[ok], rtol=0, atol=0)


def test_flash_kernel_takes_projection_views(cuda):
    """q, k and v as (B, H, L, Dh) views of one (B, L, 3 D) projection, as
    the temporal encoder hands them over: the same result as contiguous
    copies, and the output is a view of a (B, L, H, Dh) buffer."""
    b, l, heads, dh = 2, 301, 4, 96
    qkv = torch.randn((b, l, 3 * heads * dh), device="cuda")
    q, k, v = (t.reshape(b, l, heads, dh).transpose(1, 2)
               for t in qkv.split(heads * dh, dim=-1))
    out = flash_attention(q, k, v)
    ref = flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert out.transpose(1, 2).is_contiguous()


def test_flash_wrapper_rejects_what_it_does_not_take(cuda):
    """f32 only, head widths up to 192, a (B, Lk) bias; operands whose rows
    the kernels cannot read (a strided last axis, a misaligned start) are
    packed into aligned buffers and give the contiguous operands' result."""
    q, k, v = _qkv(0, 2, 2, 40, 40, 64)
    with pytest.raises(ValueError, match="f32"):
        flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="f32"):
        flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())
    q200, k200, v200 = _qkv(1, 2, 2, 40, 40, 200)
    with pytest.raises(ValueError, match="head widths up to 192"):
        flash_attention(q200, k200, v200)
    ref = flash_attention(q, k, v)
    strided = q.transpose(2, 3).contiguous().transpose(2, 3)
    torch.testing.assert_close(flash_attention(strided, k, v), ref, rtol=0,
                               atol=0)
    shifted = torch.empty(q.numel() + 1, device="cuda")[1:].view(q.shape)
    shifted.copy_(q)
    torch.testing.assert_close(flash_attention(shifted, k, v), ref, rtol=0,
                               atol=0)
    with pytest.raises(ValueError, match="bias"):
        flash_attention_fwd(q, k, v, torch.zeros((2, 39), device="cuda"))


@pytest.mark.parametrize("dh", [4, 32, 50, 80, 100, 160, 192])
def test_flash_kernels_take_every_head_width(cuda, dh):
    """K2 and K3 at head widths up to 192 (instances at 32, 64, 96, 128 and
    192 take any width up to theirs; widths that are not a multiple of 4
    are packed): out, lse and dq, dk, dv within 1e-4 of the plain
    versions' largest value, one launch each, and as (B, H, L, Dh) views
    of a (B, L, 3 D) projection through the autograd Function."""
    b, h, l = 3, 4, 129
    q, k, v = _qkv(dh, b, h, l, l, dh)
    bias = key_bias(_ragged_mask(b, l))
    before = (flash_attention.launches, flash_attention_bwd.launches)
    out, lse = flash_attention_fwd(q, k, v, bias)
    do = torch.randn(out.shape, generator=torch.Generator().manual_seed(dh)
                     ).to(cuda)
    got = flash_attention_bwd(q, k, v, bias, out, lse, do)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    ref, ref_lse = flash_attention_reference(q, k, v, bias)
    want = flash_attention_bwd_reference(q, k, v, bias, out, lse, do)
    ok = slice(0, b - 1)
    for g, r in ((out[ok], ref[ok]), *zip(got, want)):
        err = (g - r).abs().max().item()
        assert err <= 1e-4 * r.abs().max().item(), (dh, err)
    lerr = (lse[ok] - ref_lse[ok]).abs().max().item()
    assert lerr <= 1e-4 * max(1.0, ref_lse[ok].abs().max().item())
    qkv = torch.randn((b, l, 3 * h * dh), device=cuda, requires_grad=True)
    packed = flash_attention_packed(qkv, h, bias < 0)
    packed.backward(do)
    split = [t.detach().reshape(b, l, h, dh).transpose(1, 2).requires_grad_()
             for t in qkv.split(h * dh, dim=-1)]
    alone = flash_attention(*split, bias < 0)
    alone.backward(do)
    torch.testing.assert_close(packed, alone, rtol=0, atol=0)
    torch.testing.assert_close(
        qkv.grad, torch.cat([t.grad.transpose(1, 2).reshape(b, l, h * dh)
                             for t in split], -1), rtol=0, atol=0)


def _signed_error(y, ref):
    """mean((y - ref) * sign(ref)) over the mean |ref|."""
    return ((y.double() - ref) * ref.sign()).mean().item() / \
        ref.abs().mean().item()


@pytest.mark.parametrize("v_mean", [0.0, 1.0])
def test_k2_signed_error_is_near_dense_f32(cuda, v_mean):
    """At the shapes of the MIL fit's first layer (Dh 96, 4 heads, 17-33
    keys a sequence, masked tails), K2's output and K3's dq against a
    float64 evaluation carry a signed error within 2x of the dense
    float32 path's (einsum, softmax, einsum with TF32 off), or below a
    tenth of the dense path's mean |error|, where the dense path's signed
    error is at the noise floor of the reading.  v of mean 1 gives every
    key's part of P V the sign of its column, as the MIL fit's first
    layer does.  K2 now runs P V on f32 FFMA and ties each k-step's part
    of a score (the tensor core's truncation had shrunk every score);
    its signed error at the MIL fit's own first layer is read in
    chip_smoke.py's classification phase."""
    g = torch.Generator().manual_seed(0)
    b, h, l, dh = 1024, 4, 33, 96
    q, k, v, do = (torch.randn((b, h, l, dh), generator=g).to(cuda)
                   for _ in range(4))
    v = v + v_mean
    valid = torch.randint(17, l + 1, (b,), generator=g)
    mask = (torch.arange(l)[None] >= valid[:, None]).to(cuda)
    bias = key_bias(mask)
    sc = dh ** -0.5
    leaves = [t.double().requires_grad_() for t in (q, k, v)]
    ref = torch.einsum("bhlm,bhmd->bhld", torch.softmax(
        torch.einsum("bhld,bhmd->bhlm", leaves[0] * sc, leaves[1])
        + bias.double()[:, None, None, :], -1), leaves[2])
    ref_dq = torch.autograd.grad(ref, leaves[0], do.double())[0]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        q32 = q.clone().requires_grad_()
        dense = torch.einsum("bhlm,bhmd->bhld", torch.softmax(
            torch.einsum("bhld,bhmd->bhlm", q32 * sc, k)
            + bias[:, None, None, :], -1), v)
        dense_dq = torch.autograd.grad(dense, q32, do)[0]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    out, lse = flash_attention_fwd(q, k, v, bias)
    dq = flash_attention_bwd(q, k, v, bias, out, lse, do)[0]
    for name, got, want, plain in (("out", out, ref, dense),
                                   ("dq", dq, ref_dq, dense_dq)):
        want = want.detach()
        e_kernel = _signed_error(got, want)
        e_dense = _signed_error(plain, want)
        floor = ((plain.double() - want).abs().mean()
                 / want.abs().mean()).item() / 10
        assert abs(e_kernel) <= max(2 * abs(e_dense), floor), (
            name, e_kernel, e_dense, floor)


def test_auto_rule_takes_k2_at_2001_tokens(cuda):
    """prototypes_forward at (2, 1, 2000, 384) in auto mode on the card:
    the window of 2001 tokens takes K2 (one launch per layer) and its
    probabilities agree with the dense path within 5e-4, the JAX package's
    flash-vs-dense limit."""
    cfg = ModelConfig(modalities="RGB")
    model = full_model_init(torch.Generator().manual_seed(0), cfg).to(cuda)
    protos = prototypes_init(torch.Generator().manual_seed(1), 3)[1].to(cuda)
    rgb = torch.randn((2, 1, 2000, 384),
                      generator=torch.Generator().manual_seed(2)).to(cuda)
    mask = torch.zeros((2, 1, 2001), dtype=torch.bool, device=cuda)
    mask[1, 0, 1500:] = True
    before = flash_attention.launches
    with torch.inference_mode():
        out = prototypes_forward(model, cfg, rgb, mask)
        assert flash_attention.launches == before + cfg.temporal.num_layers
        dense_cfg = ModelConfig(modalities="RGB", temporal=dataclasses.replace(
            cfg.temporal, use_flash=False))
        dense = prototypes_forward(model, dense_cfg, rgb, mask)
    assert out.attn.shape == (2, 2001) and dense.attn.shape == (2, 2001, 2001)
    err = (prototype_probs(out.video_rep, protos)
           - prototype_probs(dense.video_rep, protos)).abs().max().item()
    assert err <= 5e-4, err


@pytest.mark.parametrize("b,h,lq,lk,dh", [(3, 4, 301, 301, 96),
                                          (4, 2, 37, 37, 64),
                                          (2, 4, 130, 130, 128),
                                          (3, 1, 70, 200, 96),
                                          (2, 3, 129, 65, 64),
                                          (2, 2, 65, 129, 128),
                                          (2, 4, 2001, 2001, 96),
                                          (2, 3, 1, 129, 96),
                                          (3, 2, 97, 161, 192),
                                          (2, 3, 161, 33, 192),
                                          (3, 4, 129, 129, 192),
                                          (2, 2, 257, 95, 128),
                                          (2, 3, 1, 65, 192),
                                          (2, 4, 2001, 2001, 192)])
def test_flash_bwd_kernel_matches_plain_version(cuda, b, h, lq, lk, dh):
    """K3 against its plain version on out and lse from K2, with masked
    tails that differ per element and one all-masked element: dq, dk and
    dv each within 1e-4 of the largest plain value (both f32; only the
    summation order differs)."""
    q, k, v = _qkv(lq + 2 * lk, b, h, lq, lk, dh)
    bias = key_bias(_ragged_mask(b, lk))
    out, lse = flash_attention_fwd(q, k, v, bias)
    do = torch.randn(out.shape, generator=torch.Generator().manual_seed(dh)
                     ).to(cuda)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, bias, out, lse, do)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    ref = flash_attention_bwd_reference(q, k, v, bias, out, lse, do)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        err = (g - r).abs().max().item()
        assert err <= 1e-4 * r.abs().max().item(), err


def test_flash_bwd_kernel_is_bitwise_repeatable(cuda):
    """Two K3 runs on the same inputs give the same bits: every output tile
    has one owner and its sums run in a fixed order (no atomics)."""
    q, k, v = _qkv(5, 3, 4, 301, 301, 96)
    bias = key_bias(_ragged_mask(3, 301))
    out, lse = flash_attention_fwd(q, k, v, bias)
    do = torch.randn(out.shape, generator=torch.Generator().manual_seed(6)
                     ).to(cuda)
    first = flash_attention_bwd(q, k, v, bias, out, lse, do)
    second = flash_attention_bwd(q, k, v, bias, out, lse, do)
    for a, b in zip(first, second):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("dh", [128, 192])
def test_flash_wide_kernels_are_bitwise_repeatable(cuda, dh):
    """The wide instances (Dh 128 and 192) twice on the same inputs give
    the same bits, K2 and K3: every output has one owner and every sum a
    fixed order (no atomics), with masked tails and an all-masked
    element, lengths across the 32- and 64-row tiles."""
    q, k, v = _qkv(dh + 5, 3, 4, 161, 161, dh)
    bias = key_bias(_ragged_mask(3, 161))
    out, lse = flash_attention_fwd(q, k, v, bias)
    out2, lse2 = flash_attention_fwd(q, k, v, bias)
    torch.testing.assert_close(out2, out, rtol=0, atol=0)
    torch.testing.assert_close(lse2, lse, rtol=0, atol=0)
    do = torch.randn(out.shape, generator=torch.Generator().manual_seed(dh)
                     ).to(cuda)
    first = flash_attention_bwd(q, k, v, bias, out, lse, do)
    second = flash_attention_bwd(q, k, v, bias, out, lse, do)
    for a, b in zip(first, second):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("dh", [128, 192])
def test_flash_wide_kernels_take_projection_views(cuda, dh):
    """The wide instances through `PackedFlashAttention`: q, k, v as views
    of one (B, L, 3 D) projection (L across the tiles, masked tails, one
    all-masked element) give the bits of `FlashAttention` on contiguous
    copies, forward and backward, within 1e-4 of the plain versions."""
    b, l, heads = 3, 161, 4
    qkv = torch.randn((b, l, 3 * heads * dh), device="cuda",
                      requires_grad=True)
    bias = key_bias(_ragged_mask(b, l))
    g = torch.randn((b, heads, l, dh), device="cuda")
    before = (flash_attention.launches, flash_attention_bwd.launches)
    packed = PackedFlashAttention.apply(qkv, heads, bias, True)
    packed.backward(g)
    assert (flash_attention.launches, flash_attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    leaves = [t.detach().contiguous().requires_grad_()
              for t in split_heads(qkv, heads)]
    alone = FlashAttention.apply(*leaves, bias, True)
    alone.backward(g)
    torch.testing.assert_close(packed, alone, rtol=0, atol=0)
    for got, ref in zip(split_heads(qkv.grad, heads), leaves):
        torch.testing.assert_close(got, ref.grad, rtol=0, atol=0)
    q, k, v = (t.detach() for t in leaves)
    ref, _ = flash_attention_reference(q, k, v, bias)
    ref[-1] = 0.0
    err = (packed.detach() - ref).abs().max().item()
    assert err <= 1e-4 * ref.abs().max().item(), err


def test_flash_bwd_kernel_takes_projection_views(cuda):
    """K3 through `PackedFlashAttention`: q, k, v as views of one (B, L,
    3 D) projection and dq, dk, dv written into one gradient buffer give
    the same bits as `FlashAttention` on contiguous copies, with masked
    tails and one all-masked element."""
    b, l, heads, dh = 3, 301, 4, 96
    qkv = torch.randn((b, l, 3 * heads * dh), device="cuda",
                      requires_grad=True)
    bias = key_bias(_ragged_mask(b, l))
    g = torch.randn((b, heads, l, dh), device="cuda")
    before = flash_attention_bwd.launches
    PackedFlashAttention.apply(qkv, heads, bias, True).backward(g)
    assert flash_attention_bwd.launches == before + 1
    leaves = [t.detach().contiguous().requires_grad_()
              for t in split_heads(qkv, heads)]
    FlashAttention.apply(*leaves, bias, True).backward(g)
    for got, ref in zip(split_heads(qkv.grad, heads), leaves):
        torch.testing.assert_close(got, ref.grad, rtol=0, atol=0)
        assert torch.count_nonzero(got[-1]) == 0


def test_flash_attention_gradient_runs_k3(cuda):
    """A gradient through `flash_attention` on the card runs K3 once and
    agrees with the same gradient on the CPU (plain versions) within 1e-4
    of the largest value; the all-masked element's dq, dk, dv are 0."""
    b, h, l, dh = 3, 4, 150, 96
    q, k, v = _qkv(11, b, h, l, l, dh, device="cpu")
    mask = _ragged_mask(b, l, device="cpu")
    g = torch.randn((b, h, l, dh), generator=torch.Generator().manual_seed(12))

    def grads(device):
        leaves = [t.to(device).requires_grad_() for t in (q, k, v)]
        out = flash_attention(*leaves, mask.to(device))
        out.backward(g.to(device))
        return [t.grad.cpu() for t in leaves]

    before = flash_attention_bwd.launches
    got = grads(cuda)
    assert flash_attention_bwd.launches == before + 1
    for gg, rr in zip(got, grads("cpu")):
        assert torch.count_nonzero(gg[-1]) == 0
        err = (gg - rr).abs().max().item()
        assert err <= 1e-4 * rr.abs().max().item(), err


def test_flash_bwd_wrapper_rejects_what_it_does_not_take(cuda):
    q, k, v = _qkv(2, 2, 2, 40, 40, 64)
    out, lse = flash_attention_fwd(q, k, v)
    do = torch.randn_like(out)
    with pytest.raises(ValueError, match="f32"):
        flash_attention_bwd(q.double(), k.double(), v.double(), None,
                            out, lse, do)
    q200, k200, v200 = _qkv(3, 2, 2, 40, 40, 200)
    with pytest.raises(ValueError, match="head widths up to 192"):
        flash_attention_bwd(q200, k200, v200, None, q200, lse, q200)
    # a strided cotangent and misaligned gradient buffers are packed
    ref = flash_attention_bwd(q, k, v, None, out, lse, do)
    strided = do.transpose(2, 3).contiguous().transpose(2, 3)
    for g, r in zip(flash_attention_bwd(q, k, v, None, out, lse, strided),
                    ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    shifted = torch.empty(q.numel() + 1, device="cuda")[1:].view(q.shape)
    got = flash_attention_bwd(q, k, v, None, out, lse, do,
                              grads=(shifted, torch.empty_like(k),
                                     torch.empty_like(v)))
    assert got[0] is shifted
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, v, None, out, lse[:, :, :-1], do)


def test_prototype_trainer_step_on_card_matches_cpu(cuda):
    """Two SGD steps of a 2-layer, D 384 (Dh 96) PrototypeTrainer with
    flash attention (K2 / K3 on the card, their plain versions on the CPU)
    from the same initial parameters: the same losses within 1e-5 and the
    same parameters within 1e-4 relative (f32 both sides, summation order
    only).  Each step launches K2 and K3 once per layer."""
    import numpy as np

    from sais_tpu_torch.train.loop import PrototypeTrainer
    cfg = ModelConfig(modalities="RGB", temporal=TemporalConfig(
        num_layers=2, ffn_dim=512, use_flash=True, max_positions=128))
    rng = np.random.default_rng(0)
    mask = np.zeros((4, 1, 101), bool)
    mask[1, 0, 60:] = True
    batch = {"rgb": rng.standard_normal((4, 1, 100, 384)).astype(np.float32),
             "rgb_mask": mask, "label_cols": np.array([0, 1, 1, 0], np.int32),
             "labels": np.array([0, 1, 1, 0], np.int32)}

    def run(device):
        model = full_model_init(torch.Generator().manual_seed(0), cfg)
        keys, protos = prototypes_init(torch.Generator().manual_seed(1), 2)
        tr = PrototypeTrainer(cfg, TrainConfig(lr=0.1), model, keys, protos,
                              device=device)
        losses = [float(tr.train_step(batch)[0]) for _ in range(2)]
        return losses, tr.snapshot()

    f0, b0 = flash_attention.launches, flash_attention_bwd.launches
    losses, (sd, protos) = run(cuda)
    assert flash_attention.launches - f0 == 4
    assert flash_attention_bwd.launches - b0 == 4
    ref_losses, (ref_sd, ref_protos) = run("cpu")
    np.testing.assert_allclose(losses, ref_losses, rtol=0, atol=1e-5)
    torch.testing.assert_close(protos, ref_protos, rtol=1e-4, atol=1e-6)
    for name, p in sd.items():
        torch.testing.assert_close(p, ref_sd[name], rtol=1e-4, atol=1e-6,
                                   msg=name)


def _scales(b, l, seed, device="cuda"):
    """Per-image branch scales in {0, 1/0.9} (image 0 drops its attention
    branch, image 1 its MLP branch), broadcast to (B, L, 1) bf16."""
    g = torch.Generator().manual_seed(seed)
    keep = (torch.rand((2, b), generator=g) < 0.7).float()
    keep[0, 0] = 0.0
    keep[1, min(1, b - 1)] = 0.0
    s = (keep / 0.9).to(torch.bfloat16)
    return [si[:, None, None].expand(b, l, 1).contiguous().to(device)
            for si in s]


def _close(got, ref, name, rel=2e-2):
    """Limit rel * max|ref|: kernel and plain version round at the same
    points and differ in summation order, which moves a bf16 value by an
    ulp or two (2**-8 relative) and an f32 sum over B*L rows by less."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    assert torch.isfinite(got).all(), name
    assert err <= rel * scale + 1e-6, (name, err, scale)


TRAIN_SHAPES = [(4, 197, 197), (6, 37, 37), (3, 50, 13), (2, 256, 256),
                (3, 1, 1), (3, 197, 197), (5, 37, 37)]


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("b,l,valid", TRAIN_SHAPES)
def test_train_kernels_match_plain_versions(cuda, b, l, valid, scaled):
    """K4, K5 and K6 at ViT-S widths against their plain versions on the
    same inputs, with and without branch scales (zeros included) and with
    keys masked past valid_len."""
    from sais_tpu_torch.kernels.fused_mha import (
        block_bwd_attn_reference, block_bwd_mlp_reference,
        fused_block_bwd_attn, fused_block_bwd_mlp, fused_block_fwd_train,
        vit_block_train_reference)
    x, ws = _inputs(l + 7, b, l)
    s1, s2 = _scales(b, l, l) if scaled else (None, None)
    kw = dict(num_heads=6, valid_len=valid)
    counts = (fused_block_fwd_train.launches, fused_block_bwd_mlp.launches,
              fused_block_bwd_attn.launches)
    out, x1 = fused_block_fwd_train(x, *ws, s1=s1, s2=s2, **kw)
    torch.cuda.synchronize()
    ref_out, ref_x1 = vit_block_train_reference(x, *ws, s1=s1, s2=s2, **kw)
    _close(x1[:, :valid], ref_x1[:, :valid], "x1")
    _close(out[:, :valid], ref_out[:, :valid], "out")

    g = torch.Generator().manual_seed(l)
    dout = torch.randn(x.shape, generator=g).to(cuda, torch.bfloat16)
    mlp_w = ws[4:8] + ws[10:12]
    got = fused_block_bwd_mlp(ref_x1, dout, *mlp_w, s2=s2)
    torch.cuda.synchronize()
    ref = block_bwd_mlp_reference(ref_x1, dout, *mlp_w, s2=s2)
    for name, a, r in zip(("dx1", "dfc1_w", "dfc1_b", "dfc2_w", "dfc2_b",
                           "dln2_s", "dln2_b"), got, ref):
        assert a.shape == r.shape and a.dtype == r.dtype, name
        _close(a, r, name)

    dx1 = ref[0]
    attn_w = ws[0:4] + ws[8:10]
    got = fused_block_bwd_attn(x, dx1, *attn_w, s1=s1, **kw)
    torch.cuda.synchronize()
    ref = block_bwd_attn_reference(x, dx1, *attn_w, s1=s1, **kw)
    for name, a, r in zip(("dx", "dqkv_w", "dqkv_b", "dproj_w", "dproj_b",
                           "dln1_s", "dln1_b"), got, ref):
        assert a.shape == r.shape and a.dtype == r.dtype, name
        _close(a, r, name)
    assert (fused_block_fwd_train.launches, fused_block_bwd_mlp.launches,
            fused_block_bwd_attn.launches) == tuple(c + 1 for c in counts)


def test_trainable_block_runs_the_three_kernels(cuda):
    """TrainableFusedBlock on the card: one K4 launch forward, one K5 and
    one K6 launch backward, gradients (in the weights' bf16) equal to the
    kernels' own outputs and within the plain versions' limits."""
    from sais_tpu_torch.kernels.fused_mha import (
        block_bwd_attn_reference, block_bwd_mlp_reference,
        fused_block_bwd_attn, fused_block_bwd_mlp, fused_block_fwd_train,
        trainable_fused_block, vit_block_train_reference)
    b, l = 4, 197
    x, ws = _inputs(3, b, l)
    s1, s2 = _scales(b, l, 4)
    x.requires_grad_(True)
    for w in ws:
        w.requires_grad_(True)
    counts = (fused_block_fwd_train.launches, fused_block_bwd_mlp.launches,
              fused_block_bwd_attn.launches)
    out = trainable_fused_block(x, ws, 6, l, s1=s1, s2=s2)
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(5)
                       ).to(cuda, torch.bfloat16)
    out.backward(dout)
    torch.cuda.synchronize()
    assert (fused_block_fwd_train.launches, fused_block_bwd_mlp.launches,
            fused_block_bwd_attn.launches) == tuple(c + 1 for c in counts)
    with torch.no_grad():
        xd, wd = x.detach(), [w.detach() for w in ws]
        _, x1 = vit_block_train_reference(xd, *wd, num_heads=6, valid_len=l,
                                          s1=s1, s2=s2)
        mlp = block_bwd_mlp_reference(x1, dout, *wd[4:8], *wd[10:12], s2=s2)
        attn = block_bwd_attn_reference(xd, mlp[0], *wd[0:4], *wd[8:10],
                                        num_heads=6, valid_len=l, s1=s1)
    _close(x.grad, attn[0], "dx")
    ref = dict(zip(range(12), (*attn[1:5], *mlp[1:5], *attn[5:7],
                               *mlp[5:7])))
    for i, w in enumerate(ws):
        assert w.grad.dtype == torch.bfloat16 and w.grad.shape == w.shape
        _close(w.grad, ref[i], f"weight {i}")


def test_train_kernels_reject_what_they_do_not_take(cuda):
    from sais_tpu_torch.kernels.fused_mha import (fused_block_bwd_attn,
                                                  fused_block_bwd_mlp,
                                                  fused_block_fwd_train)
    x, ws = _inputs(0, 2, 20)
    s1, s2 = _scales(2, 20, 0)
    with pytest.raises(ValueError, match="both"):
        fused_block_fwd_train(x, *ws, num_heads=6, valid_len=20, s1=s1)
    with pytest.raises(ValueError, match="scale shape"):
        fused_block_fwd_train(x, *ws, num_heads=6, valid_len=20,
                              s1=s1[:, :10], s2=s2[:, :10])
    with pytest.raises(ValueError, match="bf16"):
        fused_block_bwd_mlp(x.float(), x, *ws[4:8], *ws[10:12])
    with pytest.raises(ValueError, match="shape"):
        fused_block_bwd_mlp(x, x[:, :10], *ws[4:8], *ws[10:12])
    with pytest.raises(ValueError, match="head dim"):
        fused_block_bwd_attn(x, x, *ws[0:4], *ws[8:10], num_heads=4,
                             valid_len=20)
    with pytest.raises(ValueError, match="sequence length"):
        fused_block_bwd_attn(x[:, :0], x[:, :0], *ws[0:4], *ws[8:10],
                             num_heads=6, valid_len=1)
    wide_x, wide_ws = _inputs(2, 1, 4, d=832, mlp=4 * 832)
    with pytest.raises(NotImplementedError, match="768"):
        fused_block_bwd_mlp(wide_x, wide_x, *wide_ws[4:8], *wide_ws[10:12])
    with pytest.raises(NotImplementedError, match="768"):
        fused_block_bwd_attn(wide_x, wide_x, *wide_ws[0:4], *wide_ws[8:10],
                             num_heads=13, valid_len=4)


@pytest.mark.parametrize("b,l,valid,d", [(2, 785, 785, 384),
                                         (1, 1025, 1025, 384),
                                         (2, 800, 785, 384),
                                         (1, 785, 785, 768)])
def test_long_blocks_match_plain_versions(cuda, b, l, valid, d):
    """Past the register attention's 256 tokens (the patch-8 ViTs' 785 at
    224 px, 1025, and 800 rows with keys >= 785 masked, as the JAX package
    pads them; ViT-S and ViT-B widths): K1, K4, K5, K6 and K8 against their
    plain versions (`_close`'s limit), one launch each, and K1, K4, K6 and
    K8 twice on the same inputs, equal to the bit."""
    from sais_tpu_torch.kernels.fused_mha import (
        block_bwd_attn_reference, block_bwd_mlp_reference,
        fused_block_bwd_attn, fused_block_bwd_mlp, fused_block_fwd_train,
        fused_vit_block_int8, vit_block_int8_reference,
        vit_block_train_reference)
    heads = d // 64
    x, ws = _inputs(l + d, b, l, d=d, mlp=4 * d)
    s1, s2 = _scales(b, l, l)
    kw = dict(num_heads=heads, valid_len=valid)
    counters = (fused_vit_block, fused_block_fwd_train, fused_block_bwd_mlp,
                fused_block_bwd_attn, fused_vit_block_int8)
    counts = [c.launches for c in counters]
    dout = torch.randn(x.shape, generator=torch.Generator().manual_seed(l)
                       ).to(cuda, torch.bfloat16)
    runs = [(fused_vit_block(x, *ws, **kw),
             fused_block_fwd_train(x, *ws, s1=s1, s2=s2, **kw),
             fused_block_bwd_mlp(x, dout, *ws[4:8], *ws[10:12], s2=s2),
             fused_block_bwd_attn(x, dout, *ws[0:4], *ws[8:10], s1=s1, **kw),
             fused_vit_block_int8(x, *ws, **kw)) for _ in range(2)]
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == [n + 2 for n in counts]
    for first, second in zip(*runs):
        first = (first,) if isinstance(first, torch.Tensor) else first
        second = (second,) if isinstance(second, torch.Tensor) else second
        for i, (u, v) in enumerate(zip(first, second)):
            assert torch.equal(u, v), i
    out, (k4_out, k4_x1), mlp, attn, k8 = runs[0]
    _close(out[:, :valid], vit_block_reference(x, *ws, **kw)[:, :valid],
           "K1")
    ref_out, ref_x1 = vit_block_train_reference(x, *ws, s1=s1, s2=s2, **kw)
    _close(k4_x1[:, :valid], ref_x1[:, :valid], "K4 x1")
    _close(k4_out[:, :valid], ref_out[:, :valid], "K4 out")
    ref = block_bwd_mlp_reference(x, dout, *ws[4:8], *ws[10:12], s2=s2)
    for i, (a, r) in enumerate(zip(mlp, ref)):
        _close(a, r, f"K5 output {i}")
    ref = block_bwd_attn_reference(x, dout, *ws[0:4], *ws[8:10], s1=s1,
                                   **kw)
    for i, (a, r) in enumerate(zip(attn, ref)):
        _close(a, r, f"K6 output {i}")
    _close(k8[:, :valid], vit_block_int8_reference(x, *ws, **kw)[:, :valid],
           "K8")


@pytest.mark.parametrize("b,l,valid,d", [(4, 785, 785, 384),
                                         (2, 800, 785, 384),
                                         (2, 1025, 1025, 768)])
def test_key_tiled_attention_matches_plain_versions(cuda, b, l, valid, d):
    """The wgmma + TMA key-tiled attention past 256 tokens through the
    kernels that run it: the forward (long_attention_sm90_kernel) in K1 and
    K4, the backward pair (attention_bwd_rows_sm90_kernel,
    attention_bwd_cols_sm90_kernel) in K6, against their plain versions at
    `_close`'s limit, and each twice on the same inputs, equal to the bit.
    Four patch-8 crops (13 query tiles a head: the last group of three
    tiles a block has one), rows padded to 800 with keys >= 785 masked, and
    1025 tokens at ViT-B width (17 tiles)."""
    from sais_tpu_torch.kernels.fused_mha import (
        block_bwd_attn_reference, fused_block_bwd_attn,
        fused_block_fwd_train, vit_block_train_reference)
    x, ws = _inputs(l + 2 * d, b, l, d=d, mlp=4 * d)
    s1, s2 = _scales(b, l, l + 1)
    kw = dict(num_heads=d // 64, valid_len=valid)
    dx1 = torch.randn(x.shape, generator=torch.Generator().manual_seed(l)
                      ).to(cuda, torch.bfloat16)
    counts = [f.launches for f in (fused_vit_block, fused_block_fwd_train,
                                   fused_block_bwd_attn)]
    runs = [(fused_vit_block(x, *ws, **kw),
             fused_block_fwd_train(x, *ws, s1=s1, s2=s2, **kw),
             fused_block_bwd_attn(x, dx1, *ws[0:4], *ws[8:10], s1=s1, **kw))
            for _ in range(2)]
    torch.cuda.synchronize()
    assert [f.launches for f in (fused_vit_block, fused_block_fwd_train,
                                 fused_block_bwd_attn)] == [
        n + 2 for n in counts]
    for first, second in zip(*runs):
        first = (first,) if isinstance(first, torch.Tensor) else first
        second = (second,) if isinstance(second, torch.Tensor) else second
        for i, (u, v) in enumerate(zip(first, second)):
            assert torch.equal(u, v), i
    out, (k4_out, k4_x1), attn = runs[0]
    _close(out[:, :valid], vit_block_reference(x, *ws, **kw)[:, :valid],
           "K1")
    ref_out, ref_x1 = vit_block_train_reference(x, *ws, s1=s1, s2=s2, **kw)
    _close(k4_x1[:, :valid], ref_x1[:, :valid], "K4 x1")
    _close(k4_out[:, :valid], ref_out[:, :valid], "K4 out")
    ref = block_bwd_attn_reference(x, dx1, *ws[0:4], *ws[8:10], s1=s1, **kw)
    for i, (a, r) in enumerate(zip(attn, ref)):
        _close(a, r, f"K6 output {i}")


def test_train_backward_kernels_are_bitwise_repeatable(cuda):
    """K5 and K6 reduce every gradient in a fixed order without atomics, so
    two runs on the same inputs agree to the bit (the pretrain step's
    local-crop width at 208 rows with keys >= 197 masked, branch
    scales)."""
    from sais_tpu_torch.kernels.fused_mha import (fused_block_bwd_attn,
                                                  fused_block_bwd_mlp)
    b, l, valid = 64, 208, 197
    x, ws = _inputs(11, b, l)
    s1, s2 = _scales(b, l, 12)
    dout = torch.randn(x.shape, generator=torch.Generator().manual_seed(13)
                       ).to(cuda, torch.bfloat16)
    runs = [(fused_block_bwd_mlp(x, dout, *ws[4:8], *ws[10:12], s2=s2),
             fused_block_bwd_attn(x, dout, *ws[0:4], *ws[8:10], num_heads=6,
                                  valid_len=valid, s1=s1))
            for _ in range(2)]
    torch.cuda.synchronize()
    for first, second in zip(*runs):
        for i, (u, v) in enumerate(zip(first, second)):
            assert torch.equal(u, v), i


# ---------------------------------------------------------------------------
# K7: the fused DINO last layer + loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("norm_last", [True, False])
@pytest.mark.parametrize("batch,n_local,db,k", [(5, 3, 256, 1024),
                                                (4, 3, 128, 512),
                                                (8, 8, 256, 2048),
                                                (256, 8, 256, 512)])
def test_k7_matches_plain_version(cuda, norm_last, batch, n_local, db, k):
    """K7 against its plain version on the same inputs: loss and center
    within 1e-4 relative (f32 sums in another order), dhs, dvs and dgs
    within 1e-2 of the plain version's largest value (a bf16 rounding of
    dl may fall on the other side of a tie), dgs exactly 0 under
    norm_last_layer; one launch; two runs bitwise equal (every cross-tile
    sum is reduced in a fixed order)."""
    from sais_tpu_torch.kernels.dino_head_loss import (
        fused_loss_and_grads, fused_loss_and_grads_reference)
    hs, ht, vs, vt, gs, gt, center, sel, c = k7_inputs(
        batch, 2, n_local, db, k, seed=k)
    kw = dict(student_temp=0.1, inv_norm=1.0 / (batch * 2 * (1 + n_local)),
              use_g=not norm_last)
    args = (hs, ht, vs, vt, gs, gt, center, 0.07, sel, c)
    before = fused_loss_and_grads.launches
    got = fused_loss_and_grads(*args, **kw)
    again = fused_loss_and_grads(*args, **kw)
    torch.cuda.synchronize()
    assert fused_loss_and_grads.launches == before + 2
    ref = fused_loss_and_grads_reference(*args, **kw)
    for name, a, r in zip(("loss", "center"), got[:2], ref[:2]):
        assert (a - r).abs().max().item() <= 1e-4 * r.abs().max().item(), name
    for name, a, r in zip(("dhs", "dvs", "dgs"), got[2:], ref[2:]):
        assert a.shape == r.shape and a.dtype == torch.float32, name
        _close(a, r, name, rel=1e-2)
    if norm_last:
        assert torch.count_nonzero(got[4]) == 0
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def test_k7_takes_any_pair_structure(cuda):
    """K7 with 600 teacher rows (three windows of teacher probabilities in
    shared memory) and a random 0/1 selection, about six teacher rows a
    student row spread over all windows, the first 64 student rows pairing
    with none, against its plain version within the limits above; two runs
    bitwise equal."""
    from sais_tpu_torch.kernels.dino_head_loss import (
        fused_loss_and_grads, fused_loss_and_grads_reference)
    rs, rt, db, k = 150, 600, 128, 256
    g = torch.Generator().manual_seed(7)

    def unit(n):
        h = torch.randn((n, db), generator=g)
        return (h / h.norm(dim=-1, keepdim=True)).bfloat16().to(cuda)

    hs, ht = unit(rs), unit(rt)
    vs, vt = (torch.randn((db, k), generator=g).to(cuda) for _ in range(2))
    gs, gt = (1.0 + 0.1 * torch.randn((k,), generator=g).to(cuda)
              for _ in range(2))
    center = 0.01 * torch.randn((k,), generator=g).to(cuda)
    sel = (torch.rand((rs, rt), generator=g) < 0.01).float()
    sel[:64] = 0.0
    c = sel.sum(1, keepdim=True)
    sel, c = sel.to(cuda), c.to(cuda)
    kw = dict(student_temp=0.1, inv_norm=1.0 / c.sum().item(), use_g=True)
    args = (hs, ht, vs, vt, gs, gt, center, 0.05, sel, c)
    got = fused_loss_and_grads(*args, **kw)
    again = fused_loss_and_grads(*args, **kw)
    ref = fused_loss_and_grads_reference(*args, **kw)
    for name, a, r in zip(("loss", "center"), got[:2], ref[:2]):
        assert (a - r).abs().max().item() <= 1e-4 * r.abs().max().item(), name
    for name, a, r in zip(("dhs", "dvs", "dgs"), got[2:], ref[2:]):
        _close(a, r, name, rel=1e-2)
    assert torch.count_nonzero(got[2][:64]) == 0
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def test_k7_trainer_step_at_cli_batch(cuda):
    """DINOTrainer on the card at the CLI's default batch, 256 (2 + 2
    crops: 512 teacher rows): fused_loss defaults to K7, which launches
    once a step; the step's loss within JAX's own fused-vs-unfused limit,
    5e-3 relative (tests/test_dino_fused_loss.py), of the same step with
    fused_loss=False."""
    from sais_tpu_torch.kernels.dino_head_loss import fused_loss_and_grads
    from sais_tpu_torch.train.dino import DINOConfig, DINOTrainer
    vit_cfg = ViTConfig(image_size=32, patch_size=16, embed_dim=64, depth=2,
                        num_heads=2)
    cfg = DINOConfig(out_dim=256, batch_size=256, n_local_crops=2,
                     global_size=32, local_size=16, drop_path_rate=0.0)
    tr = DINOTrainer(vit_cfg, cfg, 2, torch.Generator().manual_seed(0),
                     fused_blocks=False)
    assert tr.fused_loss
    g = torch.Generator().manual_seed(1)
    glob = torch.randn((512, 32, 32, 3), generator=g).to(cuda)
    loc = torch.randn((512, 16, 16, 3), generator=g).to(cuda)
    before = fused_loss_and_grads.launches
    loss = tr.step(glob, loc)
    assert fused_loss_and_grads.launches == before + 1
    fused, _ = tr.loss_and_grads(glob, loc, 0.04, None)
    tr.fused_loss = False
    plain, _ = tr.loss_and_grads(glob, loc, 0.04, None)
    assert fused_loss_and_grads.launches == before + 2
    assert math.isfinite(loss)
    assert abs(fused.item() - plain.item()) <= 5e-3 * abs(plain.item())


def test_k7_function_gradients_on_card(cuda):
    """make_fused_dino_loss on the card: one launch, gradients reach hs, vs
    and gs only, equal to the kernel's own dhs, dvs, dgs times the
    cotangent."""
    from sais_tpu_torch.kernels.dino_head_loss import (fused_loss_and_grads,
                                                       make_fused_dino_loss)
    hs, ht, vs, vt, gs, gt, center, sel, c = k7_inputs(4, 2, 2, 256, 512, seed=3)
    leaves = [t.float().requires_grad_() for t in (hs, vs, gs, ht, vt, gt)]
    op = make_fused_dino_loss(0.1, 4, 2, 4, norm_last_layer=False)
    before = fused_loss_and_grads.launches
    loss, bc = op(*leaves, center, torch.full((1,), 0.04, device=cuda), sel,
                  c)
    (2.0 * loss).backward()
    assert fused_loss_and_grads.launches == before + 1
    direct = fused_loss_and_grads(hs, ht, vs, vt, gs, gt, center, 0.04, sel,
                                  c, student_temp=0.1, inv_norm=1 / 24,
                                  use_g=True)
    for leaf, d in zip(leaves[:3], direct[2:]):
        torch.testing.assert_close(leaf.grad, 2.0 * d, rtol=0, atol=0)
    assert all(leaf.grad is None for leaf in leaves[3:])


@pytest.mark.parametrize("batch,n_local,db,k", [(5, 3, 256, 1024),
                                                (8, 8, 128, 2048)])
def test_k7_epilogues_match_plain_formulas(cuda, batch, n_local, db, k):
    """K7's new epilogues alone, read from its workspace, against the
    formulas on cuBLAS products: the row statistics of each 192-column tile
    (max and sum exp), the teacher probabilities q = exp(ts - lse_t) and
    lse_s within 1e-5 of the largest value (the products summed in another
    order), and dl (bf16) within 1e-2 of it (a rounding tie of dl's f32
    value moves one element by a bf16 step)."""
    from sais_tpu_torch.kernels.dino_head_loss import (k7_intermediates,
                                                       normed_w)
    hs, ht, vs, vt, gs, gt, center, sel, c = k7_inputs(
        batch, 2, n_local, db, k, seed=k + 1)
    inv_norm = 1.0 / (batch * 2 * (1 + n_local))
    got = k7_intermediates(hs, ht, vs, vt, gs, gt, center, 0.07, sel, c,
                           student_temp=0.1, inv_norm=inv_norm, use_g=True)
    torch.cuda.synchronize()
    w = [normed_w(v, g, True)[0].bfloat16().float() for v, g in
         ((vs, gs), (vt, gt))]
    s = (hs.float() @ w[0]) * 10.0
    ts = (ht.float() @ w[1] - center) / 0.07

    def stats(x):
        tiles = [x[:, a:a + 192] for a in range(0, k, 192)]
        m = torch.stack([t.amax(1) for t in tiles], 1)
        return m, torch.stack([torch.exp(t - t.amax(1, keepdim=True)).sum(1)
                               for t in tiles], 1)

    def lse(m, l_):
        top = m.amax(1, keepdim=True)
        return (top + torch.log((l_ * torch.exp(m - top)).sum(
            1, keepdim=True)))[:, 0]

    for name, x in (("s", s), ("t", ts)):
        m, l_ = stats(x)
        _close(got["m" + name], m, "m" + name, rel=1e-5)
        _close(got["l" + name], l_, "l" + name, rel=1e-5)
    _close(got["lse_s"], lse(*stats(s)), "lse_s", rel=1e-5)
    q = torch.exp(ts - lse(*stats(ts))[:, None])
    _close(got["q"], q, "q", rel=1e-5)
    p = torch.exp(s - got["lse_s"][:, None])
    dl = ((c * p - sel @ got["q"]) * (10.0 * inv_norm)).bfloat16().float()
    _close(got["dl"].float(), dl, "dl", rel=1e-2)


def test_k7_rejects_what_it_does_not_take(cuda):
    from sais_tpu_torch.kernels.dino_head_loss import fused_loss_and_grads
    hs, ht, vs, vt, gs, gt, center, sel, c = k7_inputs(2, 2, 2, 256, 256, seed=0)
    kw = dict(student_temp=0.1, inv_norm=0.1, use_g=False)
    with pytest.raises(ValueError, match="floating-point"):
        fused_loss_and_grads(hs, ht, vs.int(), vt, gs, gt, center, 0.04, sel,
                             c, **kw)
    with pytest.raises(ValueError, match="on the card"):
        fused_loss_and_grads(hs, ht, vs.cpu(), vt, gs, gt, center, 0.04, sel,
                             c, **kw)
    with pytest.raises(ValueError, match="multiple of 128"):
        fused_loss_and_grads(hs, ht, vs[:, :200], vt[:, :200], gs[:200],
                             gt[:200], center[:200], 0.04, sel, c, **kw)
    with pytest.raises(ValueError, match="bottleneck"):
        fused_loss_and_grads(hs[:, :64], ht[:, :64], vs[:64], vt[:64], gs,
                             gt, center, 0.04, sel, c, **kw)


# ---------------------------------------------------------------------------
# K8: the W8A8 ViT block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,l,valid", [(8, 197, 197), (3, 50, 13),
                                       (2, 256, 256), (5, 1, 1)])
def test_k8_matches_plain_version(cuda, b, l, valid):
    """K8 at ViT-S widths against its plain version: within 2e-2 of the
    largest plain value (a LayerNorm or softmax summed in another order
    may move a value across a quantizer's tie, one int8 step); one
    launch."""
    from sais_tpu_torch.kernels.fused_mha import (fused_vit_block_int8,
                                                  vit_block_int8_reference)
    x, ws = _inputs(l + 11, b, l)
    kw = dict(num_heads=6, valid_len=valid)
    before = fused_vit_block_int8.launches
    out = fused_vit_block_int8(x, *ws, **kw).float()
    torch.cuda.synchronize()
    assert fused_vit_block_int8.launches == before + 1
    ref = vit_block_int8_reference(x, *ws, **kw).float()
    _close(out[:, :valid], ref[:, :valid], "out")


def test_k8_rejects_what_it_does_not_take(cuda):
    from sais_tpu_torch.kernels.fused_mha import fused_vit_block_int8
    x, ws = _inputs(0, 2, 20)
    with pytest.raises(ValueError, match="bf16"):
        fused_vit_block_int8(x.float(), *ws, num_heads=6, valid_len=20)
    with pytest.raises(ValueError, match="head dim"):
        fused_vit_block_int8(x, *ws, num_heads=4, valid_len=20)
    # the fused MLP gives each of two warpgroups 192 output columns
    x, ws = _inputs(0, 2, 20, d=512, mlp=2048)
    with pytest.raises(NotImplementedError, match="multiple of 384"):
        fused_vit_block_int8(x, *ws, num_heads=8, valid_len=20)


def test_k8_is_bitwise_repeatable(cuda):
    """K8 twice on the same inputs: the same bits (int32 sums, exact
    maxima, per-row LayerNorm in a fixed order)."""
    from sais_tpu_torch.kernels.fused_mha import fused_vit_block_int8
    x, ws = _inputs(5, 16, 197)
    kw = dict(num_heads=6, valid_len=197)
    first = fused_vit_block_int8(x, *ws, **kw)
    second = fused_vit_block_int8(x, *ws, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_k8_takes_vit_b_width(cuda):
    """K8 at ViT-B widths (D 768, 12 heads, MLP 3072: two blocks of 384
    output columns each recompute fc1) against its plain version."""
    from sais_tpu_torch.kernels.fused_mha import (fused_vit_block_int8,
                                                  vit_block_int8_reference)
    x, ws = _inputs(6, 3, 50, d=768, mlp=3072)
    kw = dict(num_heads=12, valid_len=45)
    out = fused_vit_block_int8(x, *ws, **kw).float()
    ref = vit_block_int8_reference(x, *ws, **kw).float()
    _close(out[:, :45], ref[:, :45], "out")


# (N, K) of K8's qkv and proj products and of its fc1 and fc2 shapes; M:
# the W8A8 encoder's 256 x 197 rows, ragged counts, and the patch-8
# geometries' 128 x 785 and 512 x 145 rows
I8_NK = [(1152, 384), (384, 384), (1536, 384), (384, 1536)]
I8_M = [50432, 591, 7, 100480, 74240]


@pytest.mark.parametrize("epilogue", ["bf16", "residual"])
@pytest.mark.parametrize("m", I8_M)
@pytest.mark.parametrize("n,k", I8_NK)
def test_int8_gemm_matches_exact_integer_product(cuda, n, k, m, epilogue):
    """The int8 mode of the wgmma + TMA GEMM alone against its plain
    version on the same operands (float64 integer products, exact, then
    the same dequantize and bf16 rounding): equal to the bit."""
    from sais_tpu_torch.kernels.fused_mha import (block_gemm_int8,
                                                  block_gemm_int8_reference,
                                                  quant_rows,
                                                  quantize_weight)
    g = torch.Generator().manual_seed(m + n + k)
    q, qs = quant_rows(torch.randn((m, k), generator=g))
    wq, ws = quantize_weight(0.05 * torch.randn((k, n), generator=g))
    bias = (0.05 * torch.randn((n,), generator=g)).bfloat16()
    resid = None
    if epilogue == "residual":
        resid = torch.randn((m, n), generator=g).bfloat16().to(cuda)
    args = [t.to(cuda) for t in (q, qs, wq, ws, bias)]
    before = block_gemm_int8.launches
    out = block_gemm_int8(*args, epilogue, resid)
    torch.cuda.synchronize()
    assert block_gemm_int8.launches == before + 1
    ref = block_gemm_int8_reference(*args, epilogue, resid)
    assert out.dtype == torch.bfloat16 and out.shape == (m, n)
    assert torch.equal(out, ref), (out.float() - ref.float()).abs().max()


def test_vit_int8_path_runs_k8_only(cuda):
    """vit_features(quant="int8") on a bf16 ViT-S/16 (depth cut to 3): K8
    once a block, K1 never; CLS cosine against the K1 path > 0.999."""
    from sais_tpu_torch.kernels.fused_mha import fused_vit_block_int8
    from sais_tpu_torch.models.vit import vit_features
    cfg = ViTConfig(depth=3)
    model = vit_init(torch.Generator().manual_seed(0), cfg).to(
        cuda, torch.bfloat16)
    images = torch.randn((8, 224, 224, 3),
                         generator=torch.Generator().manual_seed(1)).to(cuda)
    k1, k8 = fused_vit_block.launches, fused_vit_block_int8.launches
    with torch.inference_mode():
        got = vit_features(model, images, quant="int8")
        assert fused_vit_block.launches == k1
        assert fused_vit_block_int8.launches == k8 + cfg.depth
        ref = vit_features(model, images)
    cos = torch.nn.functional.cosine_similarity(got, ref, dim=-1)
    assert cos.mean().item() > 0.999, cos


def test_vit_patch8_paths_run_the_long_kernels(cuda, monkeypatch):
    """A ViT-S/8 (the zoo's vits8, depth cut to 3) at 224 px: 785 tokens a
    crop.  vit_forward_fused through K1 against the same path through K1's
    plain version (CLS within 5e-2 of the largest value, as at 197), and
    vit_features(quant="int8") through K8 once a block, K1 never, CLS
    cosine against the K1 path > 0.999."""
    from sais_tpu_torch.kernels.fused_mha import fused_vit_block_int8
    from sais_tpu_torch.models import vit, zoo
    from sais_tpu_torch.models.vit import vit_features
    cfg = dataclasses.replace(zoo.config("vits8"), depth=3)
    model = vit_init(torch.Generator().manual_seed(0), cfg).to(
        cuda, torch.bfloat16)
    images = torch.randn((4, 224, 224, 3),
                         generator=torch.Generator().manual_seed(1)).to(cuda)
    k1, k8 = fused_vit_block.launches, fused_vit_block_int8.launches
    with torch.inference_mode():
        got = vit_forward_fused(model, images)
        q8 = vit_features(model, images, quant="int8")
        assert fused_vit_block.launches == k1 + cfg.depth
        assert fused_vit_block_int8.launches == k8 + cfg.depth
        monkeypatch.setattr(vit, "fused_vit_block", vit_block_reference)
        ref = vit_forward_fused(model, images)
    assert got.shape == (4, 384) and torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= 5e-2 * ref.abs().max().item()
    cos = torch.nn.functional.cosine_similarity(q8, got, dim=-1)
    assert cos.mean().item() > 0.999, cos


def test_raft_f32_on_card_matches_float64(cuda):
    """RAFT 'things' (random weights from raft_init) on one pair at
    240x320, 3 iterations: float32 on the card, where raft_forward turns
    TF32 off, against the same model in float64 on the card.  Limit rtol
    1e-3, atol 2e-3, the JAX package's own against the golden torch RAFT
    (tests/test_raft_parity.py)."""
    import copy

    from sais_tpu_torch.models.raft import raft_forward, raft_init
    model = raft_init(torch.Generator().manual_seed(3)).to(cuda)
    g = torch.Generator().manual_seed(0)
    cells = torch.randint(0, 256, (1, 30, 44, 3), generator=g,
                          dtype=torch.uint8)
    texture = cells.repeat_interleave(8, 1).repeat_interleave(8, 2)
    a = texture[:, :, :320].to(cuda)
    b = texture[:, :, 24:344].to(cuda)
    with torch.inference_mode():
        got = raft_forward(model, a, b, iters=3)
        ref = raft_forward(copy.deepcopy(model).double(), a, b, iters=3,
                           compute_dtype=torch.float64)
    assert got.dtype == torch.float32 and got.shape == (1, 240, 320, 2)
    torch.testing.assert_close(got.double(), ref, rtol=1e-3, atol=2e-3)


def test_flow_renderer_on_card_matches_numpy(cuda):
    """flow_to_rgb_device on the card against the host renderer (float64
    numpy), per-image maxima, a zero patch and non-finite vectors: at most
    one uint8 level apart."""
    import numpy as np

    from sais_tpu_torch.ops.flow_viz import (flow_to_rgb_device,
                                             flow_to_rgb_uint8)
    rng = np.random.default_rng(3)
    flow = (rng.standard_normal((4, 240, 320, 2)) * 7).astype(np.float32)
    flow[0] *= 0.01
    flow[1, :4, :4] = 0
    flow[2, 3, 5] = np.nan
    flow[3, 0, 0, 1] = np.inf
    got = flow_to_rgb_device(torch.from_numpy(flow).to(cuda)).cpu().numpy()
    ref = np.stack([flow_to_rgb_uint8(f) for f in flow])
    diff = np.abs(got.astype(int) - ref.astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() > 0.999


def test_ring_in_one_process_matches_whole_sequence_kernels(cuda):
    """The 4-rank ring run by one process (`ring_in_one_process`: every
    rank's K2 / K3 step in turn, the chunks handed on in a list) at (2, 4,
    1025, 96) with a masked tail, against whole-sequence K2 and K3: out,
    lse, dq, dk and dv within 1e-4 of their largest value, the K2 / K3
    limit; 16 launches of each kernel."""
    from sais_tpu_torch.parallel.sequence import ring_in_one_process
    g = torch.Generator().manual_seed(3)
    q, k, v, do = (torch.randn((2, 4, 1025, 96), generator=g).to(cuda)
                   for _ in range(4))
    mask = torch.zeros((2, 1025), dtype=torch.bool)
    mask[1, 700:] = True
    bias = key_bias(mask.to(cuda))
    flash_attention.launches = flash_attention_bwd.launches = 0
    ring = ring_in_one_process(q, k, v, bias, 4, do)
    assert (flash_attention.launches, flash_attention_bwd.launches) == (16,
                                                                        16)
    out, lse = flash_attention_fwd(q, k, v, bias)
    whole = (out, lse) + tuple(flash_attention_bwd(q, k, v, bias, out, lse,
                                                   do))
    for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), ring, whole):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max(), name
