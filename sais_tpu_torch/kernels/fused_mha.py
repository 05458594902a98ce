"""The pre-norm ViT block (LN -> qkv -> masked softmax attention -> proj +
residual -> LN -> tanh-GELU MLP + residual) on hand-written CUDA kernels:

- K1 `fused_vit_block`, the inference forward (counterpart of
  `sais_tpu/kernels/fused_mha.py::fused_vit_block`, Pallas body
  `_block_kernel`);
- K4 `fused_block_fwd_train`, the training forward, which also returns the
  post-attention residual x1 and takes optional per-row branch scales
  (`_fused_block_fwd_train`, body `_block_fwd_train_kernel`);
- K5 `fused_block_bwd_mlp`, the backward of the MLP half
  (`_fused_block_bwd_mlp`, body `_mlp_bwd_kernel`);
- K6 `fused_block_bwd_attn`, the backward of the attention half
  (`_fused_block_bwd_attn`, bodies `_attn_bwd_kernel` and
  `_attn_bwd_tail`);
- `TrainableFusedBlock`, the autograd Function of K4 with K5 and K6 as its
  backward (`make_pallas_trainable_fused_block`);
- K8 `fused_vit_block_int8`, the opt-in W8A8 inference block: int8 x int8
  -> int32 products with per-token activation and per-channel weight
  scales, attention in bf16 (`fused_vit_block_int8`, body
  `_block_kernel_int8`), with own copies of `quantize_weight` and
  `quant_rows`; its qkv / proj product alone is `block_gemm_int8`.

Each wrapper launches its kernel (`csrc/fused_vit_block.cu`,
`csrc/fused_block_bwd_mlp.cu`, `csrc/fused_block_bwd_attn.cu`,
`csrc/fused_vit_block_int8.cu`) for a CUDA tensor, counted in its
`.launches`, and runs its plain PyTorch version for a CPU tensor; it never
falls back from one to the other.

Interface as in the JAX package: x (B, L, D), weights (in, out), the key
mask from `valid_len`, branch scales s1 and s2 (B, L, 1) in x's dtype.  The
TPU kernels' row padding to a multiple of 16, their grouping of images per
program and their packed block-diagonal attention for short sequences are
MXU tiling choices that change no value, so the port runs exact shapes.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from sais_tpu_torch.utils import profiling

_NEG_INF = -1e30
_INV127 = float(np.float32(1.0 / 127.0))   # the f32 constant JAX multiplies by


def layer_norm_f32(x, scale, bias, eps):
    """LayerNorm over the last axis, computed and returned in float32."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    return (x32 - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def _mm(a, w, dtype):
    """a @ w with f32 accumulation, rounded once to `dtype`."""
    return torch.matmul(a.float(), w.float()).to(dtype)


def _attention_ctx(qkv, num_heads, valid_len):
    """Masked softmax attention of (B, L, 3D) qkv in its dtype: f32 scores
    and softmax, keys >= valid_len masked with -1e30, p rounded to the
    dtype, ctx (B, L, D) rounded to it."""
    b, l, d3 = qkv.shape
    dh = d3 // 3 // num_heads
    dtype = qkv.dtype
    key_mask = torch.where(torch.arange(l, device=qkv.device) >= valid_len,
                           _NEG_INF, 0.0)
    q, k, v = qkv.reshape(b, l, 3, num_heads, dh).unbind(2)
    s = torch.einsum("blhd,bmhd->bhlm", q.float() * dh ** -0.5, k.float())
    p = torch.softmax(s + key_mask, dim=-1)
    ctx = torch.einsum("bhlm,bmhd->blhd", p.to(dtype).float(),
                       v.float()).to(dtype)
    return ctx.reshape(b, l, d3 // 3)


# The C entry's epilogue codes 0..7: the forward's three, then the
# backward's (K5, K6).
GEMM_EPILOGUES = ("bias", "gelu", "residual", "none", "gelu_save", "dgelu",
                  "f32", "wgrad")
_BIAS_EPILOGUES = ("bias", "gelu", "residual", "gelu_save")


def block_gemm_reference(a, w, bias, epilogue: str, residual=None,
                         row_scale=None, aux=None):
    """Plain version of the blocks' GEMM, f32 accumulation.  Forward
    epilogues, w (K, N): v = a @ w rounded to a's dtype, + bias in that
    dtype; then "bias": v; "gelu": tanh GELU of v in f32, rounded;
    "residual": residual + [row_scale *] v, the scale (one a row, shaped
    (..., 1)) applied in the dtype; "gelu_save": (v, gelu(v)), K5's fc1
    recompute.  Backward products with the weight read as its transpose,
    w (N, K): "none": a @ w^T rounded; "dgelu": (a @ w^T) * gelu'(aux) in
    f32, rounded (K5's dh, aux the saved h); "f32": a @ w^T in float32.
    "wgrad": a (R, M), w (R, N): a^T @ w in float32, a weight gradient."""
    dtype = a.dtype
    if epilogue == "none":
        return _mm(a, w.t(), dtype)
    if epilogue == "dgelu":
        return ((a.float() @ w.float().t())
                * gelu_tanh_and_grad(aux.float())[1]).to(dtype)
    if epilogue == "f32":
        return a.float() @ w.float().t()
    if epilogue == "wgrad":
        return a.float().t() @ w.float()
    if epilogue not in _BIAS_EPILOGUES:
        raise ValueError(f"epilogue {epilogue!r} not in {GEMM_EPILOGUES}")
    v = _mm(a, w, dtype) + bias
    if epilogue in ("gelu", "gelu_save"):
        g = F.gelu(v.float(), approximate="tanh").to(dtype)
        return (v, g) if epilogue == "gelu_save" else g
    if epilogue == "residual":
        if row_scale is not None:
            v = v * row_scale.to(dtype)
        return residual + v
    return v


def _block_forward(x, qkv_w, qkv_b, proj_w, proj_b, fc1_w, fc1_b, fc2_w,
                   fc2_b, ln1_s, ln1_b, ln2_s, ln2_b, num_heads, valid_len,
                   eps, s1=None, s2=None):
    """(out, x1) with the kernels' rounding points (mirrors
    `_xla_block_tanh`): f32 LN and softmax, f32-accumulated products
    rounded to x's dtype, biases, branch scales and residuals applied in
    that dtype, tanh GELU in f32, keys >= valid_len masked with -1e30."""
    dtype = x.dtype
    y = layer_norm_f32(x, ln1_s, ln1_b, eps).to(dtype)
    ctx = _attention_ctx(block_gemm_reference(y, qkv_w, qkv_b, "bias"),
                         num_heads, valid_len)
    x1 = block_gemm_reference(ctx, proj_w, proj_b, "residual", x, s1)
    y = layer_norm_f32(x1, ln2_s, ln2_b, eps).to(dtype)
    hdn = block_gemm_reference(y, fc1_w, fc1_b, "gelu")
    return block_gemm_reference(hdn, fc2_w, fc2_b, "residual", x1, s2), x1


def vit_block_reference(x, qkv_w, qkv_b, proj_w, proj_b, fc1_w, fc1_b, fc2_w,
                        fc2_b, ln1_s, ln1_b, ln2_s, ln2_b, num_heads: int,
                        valid_len: int, eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version of K1 (see `_block_forward`)."""
    return _block_forward(x, qkv_w, qkv_b, proj_w, proj_b, fc1_w, fc1_b,
                          fc2_w, fc2_b, ln1_s, ln1_b, ln2_s, ln2_b, num_heads,
                          valid_len, eps)[0]


def vit_block_train_reference(x, qkv_w, qkv_b, proj_w, proj_b, fc1_w, fc1_b,
                              fc2_w, fc2_b, ln1_s, ln1_b, ln2_s, ln2_b,
                              num_heads: int, valid_len: int,
                              eps: float = 1e-6, s1=None, s2=None):
    """Plain PyTorch version of K4: (out, x1), with x1 = x + [s1 *] attn
    and out = x1 + [s2 *] mlp (the product rounded to x's dtype)."""
    return _block_forward(x, qkv_w, qkv_b, proj_w, proj_b, fc1_w, fc1_b,
                          fc2_w, fc2_b, ln1_s, ln1_b, ln2_s, ln2_b, num_heads,
                          valid_len, eps, s1, s2)


def quantize_weight(w):
    """Per-output-channel symmetric int8 of a (K, N) weight: (int8 (K, N),
    f32 scales (1, N)), scale = max(amax, 1e-8) * (1/127), rint (half to
    even), clipped to +-127 (JAX `quantize_weight`)."""
    w32 = w.float()
    ws = torch.clamp(w32.abs().amax(0, keepdim=True), min=1e-8) * _INV127
    return torch.clamp(torch.round(w32 / ws), -127, 127).to(torch.int8), ws


def quant_rows(y32):
    """Per-row (per-token) symmetric int8 of f32 (rows, d): (int8, f32
    scales (rows, 1)) (JAX `_quant_rows`)."""
    scale = torch.clamp(y32.abs().amax(-1, keepdim=True), min=1e-8) * _INV127
    return (torch.clamp(torch.round(y32 / scale), -127, 127).to(torch.int8),
            scale)


def int8_products(q, wq):
    """The int32 products q @ wq of int8 operands, as float64: the integer
    sums are exact there (|acc| <= 127**2 K < 2**53), so they equal the
    kernel's int32 ones."""
    return torch.matmul(q.double(), wq.double())


def _int8_mm(q, row_scale, wq, ws, b):
    """f32(q @ wq) * row_scale * ws + f32(b) (JAX `_int8_mm`; int32 to f32
    rounded to nearest)."""
    return int8_products(q, wq).float() * row_scale * ws + b.float()


# K8's int8 GEMM epilogues (`block_gemm_int8`), in the C entry's order.
GEMM_I8_EPILOGUES = ("bf16", "residual")


def block_gemm_int8_reference(q, q_scale, wq, w_scale, bias, epilogue: str,
                              residual=None):
    """Plain version of K8's qkv and proj products: v = `_int8_mm(q,
    q_scale, wq, w_scale, bias)` with q (M, K) int8 and q_scale (M, 1) f32
    (`quant_rows`), wq (K, N) int8 and w_scale (1, N) f32
    (`quantize_weight`), bias (N,); "bf16": bf16(v); "residual":
    residual + bf16(v) in bf16."""
    v = _int8_mm(q, q_scale, wq, w_scale, bias).to(torch.bfloat16)
    if epilogue == "bf16":
        return v
    if epilogue == "residual":
        return residual + v
    raise ValueError(f"epilogue {epilogue!r} not in {GEMM_I8_EPILOGUES}")


def vit_block_int8_reference(x, qkv_w, qkv_b, proj_w, proj_b, fc1_w, fc1_b,
                             fc2_w, fc2_b, ln1_s, ln1_b, ln2_s, ln2_b,
                             num_heads: int, valid_len: int,
                             eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version of K8 (`_block_kernel_int8`'s rounding points):
    the weights quantized per call; LN in f32 quantized without a bf16
    round; qkv = bf16(mm); ctx (bf16) quantized from f32; x1 = x +
    bf16(mm); h = gelu_tanh(mm) in f32, quantized; out = x1 + bf16(mm)."""
    b, l, d = x.shape
    dtype = x.dtype
    wqkv, wproj, wfc1, wfc2 = (quantize_weight(w) for w in
                               (qkv_w, proj_w, fc1_w, fc2_w))
    yq, ys = quant_rows(layer_norm_f32(x, ln1_s, ln1_b, eps).reshape(-1, d))
    qkv = _int8_mm(yq, ys, *wqkv, qkv_b).to(dtype).reshape(b, l, 3 * d)
    ctx = _attention_ctx(qkv, num_heads, valid_len)
    cq, cs = quant_rows(ctx.float().reshape(-1, d))
    x1 = x + _int8_mm(cq, cs, *wproj, proj_b).to(dtype).reshape(b, l, d)
    yq, ys = quant_rows(layer_norm_f32(x1, ln2_s, ln2_b, eps).reshape(-1, d))
    h = F.gelu(_int8_mm(yq, ys, *wfc1, fc1_b), approximate="tanh")
    hq, hs = quant_rows(h)
    return x1 + _int8_mm(hq, hs, *wfc2, fc2_b).to(dtype).reshape(b, l, d)


def _ln_stats(x, eps):
    """(xhat, rstd) of LayerNorm over the last axis, float32."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    rstd = torch.rsqrt((x32 - mean).square().mean(-1, keepdim=True) + eps)
    return (x32 - mean) * rstd, rstd


def _ln_bwd(dy, xhat, rstd, scale32):
    """dx of y = xhat * scale + bias for upstream dy (all float32)."""
    dxh = dy * scale32
    return rstd * (dxh - dxh.mean(-1, keepdim=True)
                   - xhat * (dxh * xhat).mean(-1, keepdim=True))


def gelu_tanh_and_grad(h32):
    """tanh-approximate GELU and its derivative, float32 (JAX
    `_gelu_tanh_and_grad`)."""
    c, a = 0.7978845608028654, 0.044715
    t = torch.tanh(c * (h32 + a * h32 ** 3))
    return (0.5 * h32 * (1.0 + t),
            0.5 * (1.0 + t) + 0.5 * h32 * (1.0 - t * t) * c
            * (1.0 + 3 * a * h32 ** 2))


def block_bwd_mlp_reference(x1, dout, fc1_w, fc1_b, fc2_w, fc2_b, ln2_s,
                            ln2_b, eps: float = 1e-6, s2=None):
    """Plain PyTorch version of K5, the backward through out = x1 + [s2 *]
    fc2(gelu(fc1(LN2(x1)))) with `_mlp_bwd_kernel`'s rounding points.
    Returns (dx1 in x1's dtype, dfc1_w, dfc1_b, dfc2_w, dfc2_b, dln2_s,
    dln2_b in float32, shaped as the weights).  The branch sees dout * s2,
    the residual passes into dx1 unscaled."""
    dtype = x1.dtype
    d = x1.shape[-1]
    x1f, doutf = x1.reshape(-1, d), dout.reshape(-1, d)
    xhat, rstd = _ln_stats(x1f, eps)
    s32 = ln2_s.float()
    y = (xhat * s32 + ln2_b.float()).to(dtype)
    h = _mm(y, fc1_w, dtype) + fc1_b
    g32, dg32 = gelu_tanh_and_grad(h.float())
    g = g32.to(dtype)
    do2 = doutf * s2.reshape(-1, 1).to(dtype) if s2 is not None else doutf
    dfc2_w = g.float().t() @ do2.float()
    dfc2_b = do2.float().sum(0)
    dh = ((do2.float() @ fc2_w.float().t()) * dg32).to(dtype)
    dfc1_w = y.float().t() @ dh.float()
    dfc1_b = dh.float().sum(0)
    dy = dh.float() @ fc1_w.float().t()
    dx1 = (_ln_bwd(dy, xhat, rstd, s32) + doutf.float()).to(dtype)
    return (dx1.reshape(x1.shape), dfc1_w, dfc1_b, dfc2_w, dfc2_b,
            (dy * xhat).sum(0), dy.sum(0))


def _attention_bwd(qkv, dctx, num_heads, valid_len):
    """Backward of `_attention_ctx` for the cotangent dctx (B, L, D), with
    `_attn_bwd_kernel`'s rounding points: (ctx (B, L, D), dqkv (B, L, 3D))
    in qkv's dtype, dqkv's columns [dq heads | dk heads | dv heads]; p in
    f32, pb = p rounded, ds = p (dp - rowsum(dp p)) rounded, dq and dk
    scaled by dh^-0.5 in f32 before their rounding."""
    b, l, d3 = qkv.shape
    dh = d3 // 3 // num_heads
    dtype = qkv.dtype
    scale = dh ** -0.5
    key_mask = torch.where(torch.arange(l, device=qkv.device) >= valid_len,
                           _NEG_INF, 0.0)
    q, k, v = (t.float() for t in qkv.reshape(b, l, 3, num_heads,
                                               dh).unbind(2))
    dctx = dctx.reshape(b, l, num_heads, dh).float()
    s = torch.einsum("blhd,bmhd->bhlm", q * scale, k)
    p = torch.softmax(s + key_mask, dim=-1)
    pb = p.to(dtype).float()
    ctx = torch.einsum("bhlm,bmhd->blhd", pb, v).to(dtype)
    dv = torch.einsum("bhlm,blhd->bmhd", pb, dctx)
    dp = torch.einsum("blhd,bmhd->bhlm", dctx, v)
    ds = (p * (dp - (dp * p).sum(-1, keepdim=True))).to(dtype).float()
    dq = torch.einsum("bhlm,bmhd->blhd", ds, k) * scale
    dk = torch.einsum("bhlm,blhd->bmhd", ds, q) * scale
    dqkv = torch.stack([dq, dk, dv], 2).to(dtype)
    return ctx.reshape(b, l, d3 // 3), dqkv.reshape(b, l, d3)


def block_bwd_attn_reference(x, dx1, qkv_w, qkv_b, proj_w, proj_b, ln1_s,
                             ln1_b, num_heads: int, valid_len: int,
                             eps: float = 1e-6, s1=None):
    """Plain PyTorch version of K6, the backward through x1 = x + [s1 *]
    proj(attn(qkv(LN1(x)))) with `_attn_bwd_kernel` / `_attn_bwd_tail`'s
    rounding points.  Returns (dx in x's dtype, dqkv_w, dqkv_b, dproj_w,
    dproj_b, dln1_s, dln1_b in float32, shaped as the weights); dqkv's
    columns are [dq heads | dk heads | dv heads], as qkv_w's are."""
    b, l, d = x.shape
    dtype = x.dtype
    xf, dx1f = x.reshape(-1, d), dx1.reshape(-1, d)
    xhat, rstd = _ln_stats(xf, eps)
    s32 = ln1_s.float()
    y = (xhat * s32 + ln1_b.float()).to(dtype)
    qkv = (_mm(y, qkv_w, dtype) + qkv_b).reshape(b, l, 3 * d)
    dbr = dx1f * s1.reshape(-1, 1).to(dtype) if s1 is not None else dx1f
    dctx = _mm(dbr, proj_w.t(), dtype).reshape(b, l, d)
    ctx, dqkv = _attention_bwd(qkv, dctx, num_heads, valid_len)

    ctx = ctx.reshape(-1, d)
    dqkv = dqkv.reshape(-1, 3 * d)
    dproj_w = ctx.float().t() @ dbr.float()
    dproj_b = dbr.float().sum(0)
    dqkv_w = y.float().t() @ dqkv.float()
    dqkv_b = dqkv.float().sum(0)
    dy = dqkv.float() @ qkv_w.float().t()
    dx = (_ln_bwd(dy, xhat, rstd, s32) + dx1f.float()).to(dtype)
    return (dx.reshape(x.shape), dqkv_w, dqkv_b, dproj_w, dproj_b,
            (dy * xhat).sum(0), dy.sum(0))


# Shapes the CUDA kernels take (kernels/csrc/*.cu).  Any sequence length:
# up to 256 tokens the attention (forward and K6's backward) keeps a head
# in one block, past 256 the key-tiled kernels stream it.
HEAD_DIM = 64
K_TILE = 64
MAX_BWD_DIM = 768   # K5 and K6: a lane keeps D / 32 column sums
# K8's MLP launch: two consumer warpgroups of 192 output columns each (D a
# multiple of 384 up to 768, ViT-S and ViT-B), fc1 in slices of 256 hidden
# columns
INT8_D_STEP, INT8_MAX_D, INT8_MLP_SLICE = 384, 768, 256


def _check_operands(name, tensors, shapes):
    """bf16, contiguous, 16-byte aligned, on the first tensor's device, of
    the given shapes (None: any)."""
    dev = tensors[0].device
    for i, (t, shape) in enumerate(zip(tensors, shapes)):
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} operand {i}: shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if t.device != dev or t.dtype != torch.bfloat16:
            raise ValueError(f"all {name} operands must be bf16 on one "
                             f"device; operand {i} is {t.dtype} on "
                             f"{t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} operands must be contiguous and "
                             "16-byte aligned")


def _check_geometry(x, num_heads, valid_len, mlp=None):
    if x.dtype != torch.bfloat16 or x.dim() != 3:
        raise ValueError(f"the CUDA kernels take bf16 (B, L, D); got "
                         f"{x.dtype} {tuple(x.shape)}")
    b, l, d = x.shape
    if num_heads <= 0 or d != num_heads * HEAD_DIM:
        raise ValueError(f"the CUDA kernels take head dim {HEAD_DIM}; got "
                         f"D={d} with {num_heads} heads")
    if d % K_TILE or (mlp is not None and mlp % K_TILE):
        raise ValueError(f"D={d} and MLP width {mlp} must be multiples of "
                         f"{K_TILE}")
    if l < 1:
        raise ValueError(f"sequence length {l}: the kernels take L >= 1")
    if not 1 <= valid_len <= l:
        raise ValueError(f"valid_len={valid_len} outside 1..{l}")


def _block_shapes(d, mlp):
    return [(d, 3 * d), (3 * d,), (d, d), (d,), (d, mlp), (mlp,), (mlp, d),
            (d,), (d,), (d,), (d,), (d,)]


def _check_cuda_args(x, weights, num_heads, valid_len):
    mlp = weights[4].shape[1]
    _check_geometry(x, num_heads, valid_len, mlp)
    _check_operands("K1/K4", [x, *weights], [None] + _block_shapes(
        x.shape[2], mlp))


def _scale_operand(s, x):
    """A (B, L, 1) branch scale as the kernels take it: bf16, contiguous."""
    if s is None:
        return None
    if tuple(s.shape) != (*x.shape[:2], 1):
        raise ValueError(f"branch scale shape {tuple(s.shape)}, expected "
                         f"{(*x.shape[:2], 1)}")
    return s.to(torch.bfloat16).contiguous()


@functools.lru_cache(maxsize=None)
def _lib(name: str) -> ctypes.CDLL:
    """A built library with its C signatures declared (first call builds)."""
    from sais_tpu_torch.kernels import _build
    lib = _build.load(name)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    if name == "fused_vit_block":
        lib.fused_vit_block_fwd.argtypes = (
            [ptr] * 17 + [i32] * 6 + [ctypes.c_float, ptr])
        lib.fused_vit_block_fwd.restype = i32
        lib.fused_block_fwd_train.argtypes = (
            [ptr] * 19 + [i32] * 6 + [ctypes.c_float, ptr])
        lib.fused_block_fwd_train.restype = i32
        lib.vit_block_gemm_workspace.argtypes = [i32] * 3
        lib.vit_block_gemm_workspace.restype = ctypes.c_size_t
        lib.vit_block_gemm.argtypes = [ptr] * 8 + [i32] * 4 + [ptr]
        lib.vit_block_gemm.restype = i32
    elif name == "fused_block_bwd_mlp":
        lib.fused_block_bwd_mlp_workspace.argtypes = [i32] * 3
        lib.fused_block_bwd_mlp_workspace.restype = ctypes.c_size_t
        lib.fused_block_bwd_mlp.argtypes = (
            [ptr] * 23 + [i32] * 3 + [ctypes.c_float, ptr])
        lib.fused_block_bwd_mlp.restype = i32
    elif name == "fused_block_bwd_attn":
        lib.fused_block_bwd_attn_workspace.argtypes = [i32] * 3
        lib.fused_block_bwd_attn_workspace.restype = ctypes.c_size_t
        lib.fused_block_bwd_attn.argtypes = (
            [ptr] * 25 + [i32] * 5 + [ctypes.c_float, ptr])
        lib.fused_block_bwd_attn.restype = i32
    elif name == "fused_vit_block_int8":
        lib.fused_vit_block_int8_workspace.argtypes = [i32] * 3
        lib.fused_vit_block_int8_workspace.restype = ctypes.c_size_t
        lib.fused_vit_block_int8.argtypes = (
            [ptr] * 15 + [i32] * 6 + [ctypes.c_float, ptr])
        lib.fused_vit_block_int8.restype = i32
        lib.vit_block_gemm_i8.argtypes = [ptr] * 7 + [i32] * 4 + [ptr]
        lib.vit_block_gemm_i8.restype = i32
    lib.sais_cuda_error_string.argtypes = [i32]
    lib.sais_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(lib, fn, name, device, *args):
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} CUDA launch failed: "
                           + lib.sais_cuda_error_string(rc).decode())


def _on_cuda(x, name):
    """True for a CUDA tensor (the kernel), False for a CPU tensor (the
    plain version); any other device raises."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {x.device}")
    return True


@profiling.spanned("sais.kernels.fused_vit_block")
def fused_vit_block(x, qkv_w, qkv_b, proj_w, proj_b, fc1_w, fc1_b, fc2_w,
                    fc2_b, ln1_s, ln1_b, ln2_s, ln2_b, num_heads: int,
                    valid_len: int, eps: float = 1e-6) -> torch.Tensor:
    """K1, one pre-norm ViT block.  CUDA tensor: the hand-written kernel
    (bf16 only, counted in `fused_vit_block.launches`).  CPU tensor: the
    plain version `vit_block_reference`."""
    weights = (qkv_w, qkv_b, proj_w, proj_b, fc1_w, fc1_b, fc2_w, fc2_b,
               ln1_s, ln1_b, ln2_s, ln2_b)
    if not _on_cuda(x, "fused_vit_block"):
        return vit_block_reference(x, *weights, num_heads=num_heads,
                                   valid_len=valid_len, eps=eps)
    _check_cuda_args(x, weights, num_heads, valid_len)
    b, l, d = x.shape
    mlp = fc1_w.shape[1]
    lib = _lib("fused_vit_block")
    out = torch.empty_like(x)
    buf_y = torch.empty((b * l, d), dtype=x.dtype, device=x.device)
    buf_big = torch.empty((b * l, max(3 * d, mlp)), dtype=x.dtype,
                          device=x.device)
    buf_x1 = torch.empty((b * l, d), dtype=x.dtype, device=x.device)
    _launch(lib, lib.fused_vit_block_fwd, "fused_vit_block", x.device,
            *(_ptr(t) for t in (x, *weights, out, buf_y, buf_big, buf_x1)),
            b, l, d, num_heads, mlp, valid_len, eps)
    fused_vit_block.launches += 1
    return out


fused_vit_block.launches = 0


@profiling.spanned("sais.kernels.block_gemm")
def block_gemm(a, w, bias, epilogue: str, residual=None, row_scale=None,
               aux=None):
    """The blocks' GEMM alone, in the modes of `block_gemm_reference`
    (K1's and K4's four products, K5's and K6's ten): bias with "bias",
    "gelu", "residual" and "gelu_save" only; residual (and an optional row
    scale, (M,) or (M, 1)) with "residual" only; aux with "dgelu" only.
    "gelu_save" returns (h, g).  CUDA tensor: the wgmma + TMA kernel of
    `csrc/gemm_sm90.cuh` (bf16; "wgrad" split over the rows and summed in
    a second launch; counted once a call in `block_gemm.launches`), which
    the card tests hold against torch; CPU tensor: the plain version."""
    if epilogue not in GEMM_EPILOGUES:
        raise ValueError(f"epilogue {epilogue!r} not in {GEMM_EPILOGUES}")
    if (residual is None) != (epilogue != "residual") or (
            row_scale is not None and epilogue != "residual"):
        raise ValueError("the residual epilogue takes a residual (and an "
                         "optional row scale); the others take neither")
    if (aux is None) != (epilogue != "dgelu"):
        raise ValueError("the dgelu epilogue takes aux (the saved h); the "
                         "others do not")
    if (bias is None) != (epilogue not in _BIAS_EPILOGUES):
        raise ValueError(f"a bias goes with {_BIAS_EPILOGUES} only")
    if not _on_cuda(a, "block_gemm"):
        if row_scale is not None:
            row_scale = row_scale.reshape(-1, 1)
        return block_gemm_reference(a, w, bias, epilogue, residual,
                                    row_scale, aux)
    if a.dim() != 2 or w.dim() != 2:
        raise ValueError(f"block_gemm takes 2-D operands; got "
                         f"{tuple(a.shape)} and {tuple(w.shape)}")
    if epilogue == "wgrad":
        (k, m), n = a.shape, w.shape[1]
        w_shape = (k, n)
    elif epilogue in ("none", "dgelu", "f32"):
        (m, k), n = a.shape, w.shape[0]
        w_shape = (n, k)
    else:
        (m, k), n = a.shape, w.shape[1]
        w_shape = (k, n)
    if n % K_TILE or (k if epilogue != "wgrad" else m) % K_TILE:
        raise ValueError(f"N={n} and the contiguous dimension of a "
                         f"({tuple(a.shape)}) must be multiples of {K_TILE}")
    if row_scale is not None:
        if row_scale.numel() != m:
            raise ValueError(f"row_scale has {row_scale.numel()} elements, "
                             f"expected {m}")
        row_scale = row_scale.reshape(m).to(torch.bfloat16).contiguous()
    operands = [(a, None), (w, w_shape), (bias, (n,)), (residual, (m, n)),
                (row_scale, (m,)), (aux, (m, n))]
    _check_operands("block_gemm", *zip(*((t, s) for t, s in operands
                                          if t is not None)))
    lib = _lib("fused_vit_block")
    f32 = epilogue in ("f32", "wgrad")
    out = torch.empty((m, n), dtype=torch.float32 if f32 else a.dtype,
                      device=a.device)
    out2 = torch.empty_like(out) if epilogue == "gelu_save" else None
    workspace = None
    if epilogue == "wgrad":
        workspace = torch.empty((lib.vit_block_gemm_workspace(m, n, k),),
                                dtype=torch.float32, device=a.device)
    _launch(lib, lib.vit_block_gemm, "block_gemm", a.device,
            *(_ptr(t) for t in (a, w, bias, residual if aux is None else aux,
                                row_scale, out, out2, workspace)),
            m, n, k, GEMM_EPILOGUES.index(epilogue))
    block_gemm.launches += 1
    return (out, out2) if epilogue == "gelu_save" else out


block_gemm.launches = 0


@profiling.spanned("sais.kernels.block_gemm_int8")
def block_gemm_int8(q, q_scale, wq, w_scale, bias, epilogue: str,
                    residual=None):
    """K8's qkv / proj product alone, in the modes of
    `block_gemm_int8_reference` (a residual with "residual" only).  CUDA
    tensor: the int8 mode of the wgmma + TMA GEMM (`csrc/gemm_sm90.cuh`,
    s8 x s8 -> s32, the weight passed transposed, (N, K), as K8 stores it;
    counted in `block_gemm_int8.launches`), which the card tests hold
    against an exact integer product; CPU tensor: the plain version."""
    if epilogue not in GEMM_I8_EPILOGUES:
        raise ValueError(f"epilogue {epilogue!r} not in {GEMM_I8_EPILOGUES}")
    if (residual is None) != (epilogue != "residual"):
        raise ValueError("the residual epilogue takes a residual; the other "
                         "does not")
    if not _on_cuda(q, "block_gemm_int8"):
        return block_gemm_int8_reference(q, q_scale, wq, w_scale, bias,
                                         epilogue, residual)
    if q.dtype != torch.int8 or wq.dtype != torch.int8 or q.dim() != 2 \
            or wq.dim() != 2 or q.shape[1] != wq.shape[0]:
        raise ValueError(f"block_gemm_int8 takes int8 q (M, K) and wq (K, "
                         f"N); got {q.dtype} {tuple(q.shape)} and "
                         f"{wq.dtype} {tuple(wq.shape)}")
    (m, k), n = q.shape, wq.shape[1]
    if k % 16 or n % K_TILE:
        raise ValueError(f"K={k} must be a multiple of 16 and N={n} of "
                         f"{K_TILE}")
    if q_scale.numel() != m or w_scale.numel() != n:
        raise ValueError("q_scale takes one scale a row, w_scale one a "
                         "column")
    _check_operands("block_gemm_int8", *zip(*(
        (t, s) for t, s in ((bias, (n,)), (residual, (m, n)))
        if t is not None)))
    q = q.contiguous()
    wt = wq.t().contiguous()
    qs = q_scale.reshape(m).float().contiguous()
    ws = w_scale.reshape(n).float().contiguous()
    if q.data_ptr() % 16 or bias.device != q.device:
        raise ValueError("block_gemm_int8 operands must be 16-byte aligned "
                         "and on one device")
    lib = _lib("fused_vit_block_int8")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=q.device)
    _launch(lib, lib.vit_block_gemm_i8, "block_gemm_int8", q.device,
            *(_ptr(t) for t in (q, qs, wt, ws, bias, residual, out)),
            m, n, k, GEMM_I8_EPILOGUES.index(epilogue))
    block_gemm_int8.launches += 1
    return out


block_gemm_int8.launches = 0


@profiling.spanned("sais.kernels.fused_vit_block_int8")
def fused_vit_block_int8(x, qkv_w, qkv_b, proj_w, proj_b, fc1_w, fc1_b,
                         fc2_w, fc2_b, ln1_s, ln1_b, ln2_s, ln2_b,
                         num_heads: int, valid_len: int,
                         eps: float = 1e-6) -> torch.Tensor:
    """K8, one pre-norm ViT block with W8A8 products (the weights quantized
    at every call).  CUDA tensor: the hand-written kernel (bf16 only, D a
    multiple of 384 up to 768 and an MLP width a multiple of 256; counted
    in `fused_vit_block_int8.launches`).  CPU tensor: the plain version
    `vit_block_int8_reference`."""
    weights = (qkv_w, qkv_b, proj_w, proj_b, fc1_w, fc1_b, fc2_w, fc2_b,
               ln1_s, ln1_b, ln2_s, ln2_b)
    if not _on_cuda(x, "fused_vit_block_int8"):
        return vit_block_int8_reference(x, *weights, num_heads=num_heads,
                                        valid_len=valid_len, eps=eps)
    _check_cuda_args(x, weights, num_heads, valid_len)
    b, l, d = x.shape
    mlp = fc1_w.shape[1]
    if d % INT8_D_STEP or d > INT8_MAX_D or mlp % INT8_MLP_SLICE:
        raise NotImplementedError(
            f"K8 takes D a multiple of {INT8_D_STEP} up to {INT8_MAX_D} and "
            f"an MLP width a multiple of {INT8_MLP_SLICE} (its fused MLP "
            f"gives each of two warpgroups 192 output columns); got D={d}, "
            f"MLP {mlp}")
    lib = _lib("fused_vit_block_int8")
    out = torch.empty_like(x)
    workspace = torch.empty(
        (lib.fused_vit_block_int8_workspace(b * l, d, mlp),),
        dtype=torch.uint8, device=x.device)
    _launch(lib, lib.fused_vit_block_int8, "fused_vit_block_int8", x.device,
            *(_ptr(t) for t in (x, *weights, out, workspace)),
            b, l, d, num_heads, mlp, valid_len, eps)
    fused_vit_block_int8.launches += 1
    return out


fused_vit_block_int8.launches = 0


@profiling.spanned("sais.kernels.fused_block_fwd_train")
def fused_block_fwd_train(x, qkv_w, qkv_b, proj_w, proj_b, fc1_w, fc1_b,
                          fc2_w, fc2_b, ln1_s, ln1_b, ln2_s, ln2_b,
                          num_heads: int, valid_len: int, eps: float = 1e-6,
                          s1=None, s2=None):
    """K4, the training forward of one block: (out, x1).  s1, s2: optional
    (B, L, 1) branch scales (stochastic depth), both or neither.  CUDA
    tensor: the hand-written kernel (counted in
    `fused_block_fwd_train.launches`); CPU tensor: the plain version
    `vit_block_train_reference`."""
    weights = (qkv_w, qkv_b, proj_w, proj_b, fc1_w, fc1_b, fc2_w, fc2_b,
               ln1_s, ln1_b, ln2_s, ln2_b)
    if (s1 is None) != (s2 is None):
        raise ValueError("pass both branch scales s1 and s2, or neither")
    if not _on_cuda(x, "fused_block_fwd_train"):
        return vit_block_train_reference(x, *weights, num_heads=num_heads,
                                         valid_len=valid_len, eps=eps,
                                         s1=s1, s2=s2)
    _check_cuda_args(x, weights, num_heads, valid_len)
    s1, s2 = _scale_operand(s1, x), _scale_operand(s2, x)
    b, l, d = x.shape
    mlp = fc1_w.shape[1]
    lib = _lib("fused_vit_block")
    out, x1 = torch.empty_like(x), torch.empty_like(x)
    buf_y = torch.empty((b * l, d), dtype=x.dtype, device=x.device)
    buf_big = torch.empty((b * l, max(3 * d, mlp)), dtype=x.dtype,
                          device=x.device)
    _launch(lib, lib.fused_block_fwd_train, "fused_block_fwd_train",
            x.device, *(_ptr(t) for t in (x, *weights, s1, s2, out, x1, buf_y,
                                          buf_big)),
            b, l, d, num_heads, mlp, valid_len, eps)
    fused_block_fwd_train.launches += 1
    return out, x1


fused_block_fwd_train.launches = 0


def _f32_like(w, device):
    return torch.empty(w.shape, dtype=torch.float32, device=device)


def _check_bwd_width(d):
    if d > MAX_BWD_DIM:
        raise NotImplementedError(
            f"D={d} above the backward kernels' {MAX_BWD_DIM} (each lane of "
            "their row passes keeps D / 32 column sums in registers)")


@profiling.spanned("sais.kernels.fused_block_bwd_mlp")
def fused_block_bwd_mlp(x1, dout, fc1_w, fc1_b, fc2_w, fc2_b, ln2_s, ln2_b,
                        eps: float = 1e-6, s2=None):
    """K5, the backward of the MLP half: (dx1, dfc1_w, dfc1_b, dfc2_w,
    dfc2_b, dln2_s, dln2_b), weight gradients in float32.  CUDA tensor: the
    hand-written kernel (counted in `fused_block_bwd_mlp.launches`); CPU
    tensor: the plain version `block_bwd_mlp_reference`."""
    weights = (fc1_w, fc1_b, fc2_w, fc2_b, ln2_s, ln2_b)
    if not _on_cuda(x1, "fused_block_bwd_mlp"):
        return block_bwd_mlp_reference(x1, dout, *weights, eps=eps, s2=s2)
    mlp = fc1_w.shape[1]
    _check_geometry(x1, x1.shape[2] // HEAD_DIM, 1, mlp)
    b, l, d = x1.shape
    _check_bwd_width(d)
    _check_operands("K5", [x1, dout, *weights],
                    [x1.shape, x1.shape, (d, mlp), (mlp,), (mlp, d), (d,),
                     (d,), (d,)])
    s2 = _scale_operand(s2, x1)
    rows, dev = b * l, x1.device
    lib = _lib("fused_block_bwd_mlp")
    dx1 = torch.empty_like(x1)
    grads = [_f32_like(w, dev) for w in weights]
    bf = dict(dtype=torch.bfloat16, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    buf_y = torch.empty((rows, d), **bf)
    buf_do2 = torch.empty((rows, d), **bf) if s2 is not None else None
    buf_h = torch.empty((rows, mlp), **bf)
    buf_g = torch.empty((rows, mlp), **bf)
    buf_dy = torch.empty((rows, d), **f32)
    buf_stats = torch.empty((2 * rows,), **f32)
    workspace = torch.empty(
        (lib.fused_block_bwd_mlp_workspace(rows, d, mlp),), **f32)
    _launch(lib, lib.fused_block_bwd_mlp, "fused_block_bwd_mlp", dev,
            *(_ptr(t) for t in (x1, dout, s2, *weights, dx1, *grads, buf_y,
                                buf_do2, buf_h, buf_g, buf_dy, buf_stats,
                                workspace)),
            rows, d, mlp, eps)
    fused_block_bwd_mlp.launches += 1
    return (dx1, *grads)


fused_block_bwd_mlp.launches = 0


@profiling.spanned("sais.kernels.fused_block_bwd_attn")
def fused_block_bwd_attn(x, dx1, qkv_w, qkv_b, proj_w, proj_b, ln1_s, ln1_b,
                         num_heads: int, valid_len: int, eps: float = 1e-6,
                         s1=None):
    """K6, the backward of the attention half: (dx, dqkv_w, dqkv_b,
    dproj_w, dproj_b, dln1_s, dln1_b), weight gradients in float32.  CUDA
    tensor: the hand-written kernel (counted in
    `fused_block_bwd_attn.launches`); CPU tensor: the plain version
    `block_bwd_attn_reference`."""
    weights = (qkv_w, qkv_b, proj_w, proj_b, ln1_s, ln1_b)
    if not _on_cuda(x, "fused_block_bwd_attn"):
        return block_bwd_attn_reference(x, dx1, *weights,
                                        num_heads=num_heads,
                                        valid_len=valid_len, eps=eps, s1=s1)
    _check_geometry(x, num_heads, valid_len)
    b, l, d = x.shape
    _check_bwd_width(d)
    _check_operands("K6", [x, dx1, *weights],
                    [x.shape, x.shape, (d, 3 * d), (3 * d,), (d, d), (d,),
                     (d,), (d,)])
    s1 = _scale_operand(s1, x)
    rows, dev = b * l, x.device
    lib = _lib("fused_block_bwd_attn")
    dx = torch.empty_like(x)
    grads = [_f32_like(w, dev) for w in weights]
    bf = dict(dtype=torch.bfloat16, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    buf_y, buf_dctx, buf_ctx = (torch.empty((rows, d), **bf)
                                for _ in range(3))
    buf_dbr = torch.empty((rows, d), **bf) if s1 is not None else None
    buf_qkv, buf_dqkv = (torch.empty((rows, 3 * d), **bf) for _ in range(2))
    buf_dy = torch.empty((rows, d), **f32)
    buf_stats = torch.empty((2 * rows,), **f32)
    workspace = torch.empty(
        (lib.fused_block_bwd_attn_workspace(b, l, d),), **f32)
    _launch(lib, lib.fused_block_bwd_attn, "fused_block_bwd_attn", dev,
            *(_ptr(t) for t in (x, dx1, s1, *weights, dx, *grads, buf_y,
                                buf_dbr, buf_dctx, buf_ctx, buf_qkv,
                                buf_dqkv, buf_dy, buf_stats, workspace)),
            b, l, d, num_heads, valid_len, eps)
    fused_block_bwd_attn.launches += 1
    return (dx, *grads)


fused_block_bwd_attn.launches = 0


class TrainableFusedBlock(torch.autograd.Function):
    """One trainable block: K4 forward, K5 then K6 backward (counterpart of
    `make_pallas_trainable_fused_block`).  Only x, x1, the scales and the
    weights are saved; the backward recomputes the rest inside the kernels.
    Weight gradients come back in the weights' dtype; the branch scales
    are stochastic-depth draws, not parameters, and get no gradient.

    apply(x, s1, s2, num_heads, valid_len, eps, *weights)."""

    @staticmethod
    def forward(ctx, x, s1, s2, num_heads, valid_len, eps, *weights):
        out, x1 = fused_block_fwd_train(x, *weights, num_heads=num_heads,
                                        valid_len=valid_len, eps=eps, s1=s1,
                                        s2=s2)
        ctx.save_for_backward(x, x1, s1, s2, *weights)
        ctx.cfg = (num_heads, valid_len, eps)
        return out

    @staticmethod
    def backward(ctx, gout):
        x, x1, s1, s2, *weights = ctx.saved_tensors
        num_heads, valid_len, eps = ctx.cfg
        (qkv_w, qkv_b, proj_w, proj_b, fc1_w, fc1_b, fc2_w, fc2_b, ln1_s,
         ln1_b, ln2_s, ln2_b) = weights
        dx1, dfc1_w, dfc1_b, dfc2_w, dfc2_b, dln2_s, dln2_b = \
            fused_block_bwd_mlp(x1, gout.contiguous(), fc1_w, fc1_b, fc2_w,
                                fc2_b, ln2_s, ln2_b, eps=eps, s2=s2)
        dx, dqkv_w, dqkv_b, dproj_w, dproj_b, dln1_s, dln1_b = \
            fused_block_bwd_attn(x, dx1, qkv_w, qkv_b, proj_w, proj_b, ln1_s,
                                 ln1_b, num_heads=num_heads,
                                 valid_len=valid_len, eps=eps, s1=s1)
        grads = (dqkv_w, dqkv_b, dproj_w, dproj_b, dfc1_w, dfc1_b, dfc2_w,
                 dfc2_b, dln1_s, dln1_b, dln2_s, dln2_b)
        return (dx, None, None, None, None, None,
                *(g.to(w.dtype) for g, w in zip(grads, weights)))


def trainable_fused_block(x, weights, num_heads: int, valid_len: int,
                          eps: float = 1e-6, s1=None, s2=None):
    """`TrainableFusedBlock` with keyword arguments; `weights` in the
    order of `fused_vit_block`'s."""
    return TrainableFusedBlock.apply(x, s1, s2, num_heads, valid_len, eps,
                                     *weights)
