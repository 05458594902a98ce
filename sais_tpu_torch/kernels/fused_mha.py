"""K1: the forward of one whole pre-norm ViT block (LN -> qkv -> masked
softmax attention -> proj + residual -> LN -> tanh-GELU MLP + residual).

Counterpart of `sais_tpu/kernels/fused_mha.py::fused_vit_block` (Pallas
body `_block_kernel`).  `fused_vit_block` launches the hand-written CUDA
kernels of `csrc/fused_vit_block.cu` for a CUDA tensor and runs the plain
PyTorch version `vit_block_reference` for a CPU tensor; it never falls
back from one to the other.

Interface as in the JAX package: x (B, L, D), weights (in, out), the key
mask from `valid_len`.  The TPU kernel's row padding to a multiple of 16
and its grouping of images per program are MXU tiling choices that change
no value, so the port runs exact shapes.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

_NEG_INF = -1e30


def layer_norm_f32(x, scale, bias, eps):
    """LayerNorm over the last axis, computed and returned in float32."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    return (x32 - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def _mm(a, w, dtype):
    """a @ w with f32 accumulation, rounded once to `dtype`."""
    return torch.matmul(a.float(), w.float()).to(dtype)


def vit_block_reference(x, qkv_w, qkv_b, proj_w, proj_b, fc1_w, fc1_b, fc2_w,
                        fc2_b, ln1_s, ln1_b, ln2_s, ln2_b, num_heads: int,
                        valid_len: int, eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version of K1 with the kernel's rounding points
    (mirrors `_xla_block_tanh`): f32 LN and softmax, f32-accumulated
    products rounded to x's dtype, biases and residuals added in that
    dtype, tanh GELU in f32, keys >= valid_len masked with -1e30."""
    b, l, d = x.shape
    dh = d // num_heads
    dtype = x.dtype
    key_mask = torch.where(torch.arange(l, device=x.device) >= valid_len,
                           _NEG_INF, 0.0)

    y = layer_norm_f32(x, ln1_s, ln1_b, eps).to(dtype)
    qkv = (_mm(y, qkv_w, dtype) + qkv_b).reshape(b, l, 3, num_heads, dh)
    q, k, v = qkv.unbind(2)
    s = torch.einsum("blhd,bmhd->bhlm", q.float() * dh ** -0.5, k.float())
    p = torch.softmax(s + key_mask, dim=-1)
    ctx = torch.einsum("bhlm,bmhd->blhd", p.to(dtype).float(),
                       v.float()).to(dtype)
    x = x + (_mm(ctx.reshape(b, l, d), proj_w, dtype) + proj_b)

    y = layer_norm_f32(x, ln2_s, ln2_b, eps).to(dtype)
    hdn = _mm(y, fc1_w, dtype) + fc1_b
    hdn = F.gelu(hdn.float(), approximate="tanh").to(dtype)
    return x + (_mm(hdn, fc2_w, dtype) + fc2_b)


# Shapes the CUDA kernels take (kernels/csrc/fused_vit_block.cu).
HEAD_DIM = 64
MAX_LEN = 256
K_TILE = 64


def _check_cuda_args(x, weights, num_heads, valid_len):
    if x.dtype != torch.bfloat16 or x.dim() != 3:
        raise ValueError(f"fused_vit_block on CUDA takes bf16 (B, L, D); "
                         f"got {x.dtype} {tuple(x.shape)}")
    b, l, d = x.shape
    mlp = weights[4].shape[1]
    if num_heads <= 0 or d != num_heads * HEAD_DIM:
        raise ValueError(f"the CUDA kernel takes head dim {HEAD_DIM}; got "
                         f"D={d} with {num_heads} heads")
    if d % K_TILE or mlp % K_TILE:
        raise ValueError(f"D={d} and MLP width {mlp} must be multiples of "
                         f"{K_TILE}")
    if not 1 <= l <= MAX_LEN:
        raise NotImplementedError(
            f"sequence length {l} outside the kernel's 1..{MAX_LEN} (the "
            "score rows of a query live in registers)")
    if not 1 <= valid_len <= l:
        raise ValueError(f"valid_len={valid_len} outside 1..{l}")
    shapes = [(d, 3 * d), (3 * d,), (d, d), (d,), (d, mlp), (mlp,),
              (mlp, d), (d,), (d,), (d,), (d,), (d,)]
    for i, (w, shape) in enumerate(zip(weights, shapes)):
        if tuple(w.shape) != shape:
            raise ValueError(f"weight {i}: shape {tuple(w.shape)}, "
                             f"expected {shape}")
    for t in (x, *weights):
        if t.device != x.device or t.dtype != torch.bfloat16:
            raise ValueError("all K1 operands must be bf16 on x's device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("K1 operands must be contiguous and 16-byte "
                             "aligned")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (first call builds)."""
    from sais_tpu_torch.kernels import _build
    lib = _build.load("fused_vit_block")
    lib.fused_vit_block_fwd.argtypes = (
        [ctypes.c_void_p] * 17 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_void_p])
    lib.fused_vit_block_fwd.restype = ctypes.c_int
    lib.sais_cuda_error_string.argtypes = [ctypes.c_int]
    lib.sais_cuda_error_string.restype = ctypes.c_char_p
    return lib


def fused_vit_block(x, qkv_w, qkv_b, proj_w, proj_b, fc1_w, fc1_b, fc2_w,
                    fc2_b, ln1_s, ln1_b, ln2_s, ln2_b, num_heads: int,
                    valid_len: int, eps: float = 1e-6) -> torch.Tensor:
    """One pre-norm ViT block.  CUDA tensor: the hand-written kernel (bf16
    only, counted in `fused_vit_block.launches`).  CPU tensor: the plain
    version `vit_block_reference`."""
    weights = (qkv_w, qkv_b, proj_w, proj_b, fc1_w, fc1_b, fc2_w, fc2_b,
               ln1_s, ln1_b, ln2_s, ln2_b)
    if x.device.type == "cpu":
        return vit_block_reference(x, *weights, num_heads=num_heads,
                                   valid_len=valid_len, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_vit_block: no kernel for {x.device}")
    _check_cuda_args(x, weights, num_heads, valid_len)
    b, l, d = x.shape
    mlp = fc1_w.shape[1]
    lib = _lib()
    out = torch.empty_like(x)
    buf_y = torch.empty((b * l, d), dtype=x.dtype, device=x.device)
    buf_big = torch.empty((b * l, max(3 * d, mlp)), dtype=x.dtype,
                          device=x.device)
    buf_x1 = torch.empty((b * l, d), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = lib.fused_vit_block_fwd(
            *(t.data_ptr() for t in (x, *weights, out, buf_y, buf_big,
                                     buf_x1)),
            b, l, d, num_heads, mlp, valid_len, eps, stream)
    if rc != 0:
        raise RuntimeError("fused_vit_block CUDA launch failed: "
                           + lib.sais_cuda_error_string(rc).decode())
    fused_vit_block.launches += 1
    return out


fused_vit_block.launches = 0
