"""K2 and K3: masked flash attention in f32, forward and backward.

Counterpart of `sais_tpu/kernels/flash_attention.py`: K2 is the forward
(`flash_attention` -> `_run_fwd` -> Pallas body `_flash_fwd_kernel`), K3
the backward (`_run_bwd` -> `_flash_bwd_dq_kernel` and
`_flash_bwd_dkv_kernel`), and `FlashAttention` takes the place of the
custom VJP (`_flash_core`) that joins them.  For a CUDA tensor the wrappers
launch the hand-written kernels of `csrc/flash_attention.cu` (K2) and
`csrc/flash_attention_bwd.cu` (K3); for a CPU tensor they run the plain
PyTorch versions `flash_attention_reference` and
`flash_attention_bwd_reference`.  Neither falls back from one to the
other.  The kernels run their f32 products on the tensor cores as three
TF32 products of a big / small split of the operands (3xTF32,
`csrc/flash_tf32.cuh`), which keeps f32 accuracy; K2's P V runs on f32
FFMA, whose round-to-nearest sums keep its signed error at the dense f32
path's (`csrc/flash_attention.cu`).

Semantics kept from the JAX kernels:

- the query is pre-scaled once in f32 (q * Dh**-0.5);
- masked keys get an additive f32 bias of -1e30 (not -inf), and the
  online-softmax state starts at m = -1e30, so no inf - inf arises;
- out = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30));
- the backward recomputes p = exp((s + bias) - lse) from the saved lse,
  with delta = rowsum(dO * out) in f32 computed outside the kernels (as
  JAX does); the bias gets no gradient;
- `flash_attention` gives zeros for every row of a batch element whose
  keys are all masked (flash_attention.py:496-504), and its backward
  zeroes that element's cotangent, so dq, dk and dv are exactly 0 there.

The JAX package pads L to its block sizes and Dh to 128 lanes, and splits
long K/V into VMEM-sized chunks; those are TPU tiling choices that change
no value.  The CUDA kernels run exact lengths (ragged tiles are masked
inside them) and stream from device memory, so they have no length
ceiling.  They take any head width up to `MAX_HEAD_DIM` = 192 (a rep_dim
of up to 768 over 4 heads): compiled for 32, 64, 96, 128 and 192, each
instance zero-fills the columns past the runtime width, JAX's zero
padding.  A width that is not a multiple of 4, or operands whose rows
are not 16-byte aligned, are first copied by the wrapper into zero-padded
aligned buffers (the results are copied back); the temporal encoder's
widths with rep_dim a multiple of 16 never need it.  They take strides:
q, k and v may be (B, H, L, Dh) views of the temporal encoder's (B, L,
3 D) projection, the forward's output is written
into a (B, L, H, Dh) buffer and returned as its (B, H, L, Dh) view, and
`PackedFlashAttention`'s backward writes dq, dk and dv into one (B, L, 3 D)
buffer, the gradient of the projection, so the encoder transposes nothing
in either pass.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

_NEG_INF = -1e30
MAX_HEAD_DIM = 192   # the widest instance of the CUDA kernels

Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def key_bias(key_padding_mask: torch.Tensor) -> torch.Tensor:
    """(B, L) bool, True = pad -> (B, L) f32 additive bias, 0 or -1e30."""
    return torch.where(key_padding_mask, _NEG_INF, 0.0).float()


def _any_valid(bias: torch.Tensor) -> torch.Tensor:
    """(B, Lk) bias -> (B, 1, 1, 1) f32: 1 where the element has a valid
    key, 0 where every key is masked (the kernels' rule: bias > -1e30)."""
    return (bias > _NEG_INF).any(-1).float()[:, None, None, None]


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              bias: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2 with `_run_fwd`'s contract: q (B, H, Lq,
    Dh), k and v (B, H, Lk, Dh), bias (B, Lk) f32 or None -> (out (B, H,
    Lq, Dh) in q's dtype, lse (B, H, Lq) f32).  One softmax over the whole
    key row, with the kernel's m floor of -1e30 and l floor of 1e-30."""
    dh = q.shape[-1]
    s = torch.einsum("bhld,bhmd->bhlm", q.float() * dh ** -0.5, k.float())
    if bias is not None:
        s = s + bias.float()[:, None, None, :]
    m = s.amax(-1, keepdim=True).clamp_min(_NEG_INF)
    p = torch.exp(s - m)
    l_safe = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhlm,bhmd->bhld", p, v.float()) / l_safe
    return out.to(q.dtype), (m + torch.log(l_safe))[..., 0]


def _delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """rowsum(dO * out) in f32, (B, H, Lq) contiguous (flash_attention.py
    :220-221, outside the kernels as in JAX).  The operands are made
    contiguous first: PyTorch's CUDA sum orders its terms by the memory
    layout, and the gradients must not depend on the cotangent's
    strides."""
    return (do.float().contiguous() * out.float().contiguous()).sum(
        -1).contiguous()


def flash_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor,
                                  bias: Optional[torch.Tensor],
                                  out: torch.Tensor, lse: torch.Tensor,
                                  do: torch.Tensor) -> Grads:
    """Plain PyTorch version of K3 with `_run_bwd`'s contract, written out
    from the formulas (no autograd):

        q' = q * scale;  p = exp((q' k^T + bias) - lse);  dv = p^T dO
        dp = dO v^T;  ds = p * (dp - delta);  dq = ds k * scale;  dk = ds^T q'

    with delta = rowsum(dO * out).  Lq and Lk may differ; -> (dq, dk, dv)
    in f32, shaped like q, k and v."""
    scale = q.shape[-1] ** -0.5
    qs = q.float() * scale
    s = torch.einsum("bhld,bhmd->bhlm", qs, k.float())
    if bias is not None:
        s = s + bias.float()[:, None, None, :]
    p = torch.exp(s - lse.float()[..., None])
    do = do.float()
    dv = torch.einsum("bhlm,bhld->bhmd", p, do)
    dp = torch.einsum("bhld,bhmd->bhlm", do, v.float())
    ds = p * (dp - _delta(out, do)[..., None])
    dq = torch.einsum("bhlm,bhmd->bhld", ds, k.float()) * scale
    dk = torch.einsum("bhlm,bhld->bhmd", ds, qs)
    return dq, dk, dv


def _check_layout(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.dim() != 4 or t.dtype != torch.float32:
        raise ValueError(f"flash attention on CUDA takes f32 (B, H, L, Dh); "
                         f"{name} is {t.dtype} {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"all flash-attention operands must be on q's "
                         f"device; {name} is on {t.device}")


def _aligned(t: torch.Tensor) -> bool:
    """The kernels' row rule: a contiguous last axis of a multiple of 4
    elements, strides in multiples of 4 and a 16-byte aligned start."""
    return (t.shape[-1] % 4 == 0 and t.stride(-1) == 1
            and not any(s % 4 for s in t.stride()[:3])
            and t.data_ptr() % 16 == 0)


def _padded(t: torch.Tensor) -> torch.Tensor:
    """t copied into a contiguous buffer whose last axis is zero-padded to
    a multiple of 4 (the kernels' 16-byte rows)."""
    pad = -t.shape[-1] % 4
    return torch.nn.functional.pad(t, (0, pad)).contiguous()


def _check_cuda_args(q, k, v, bias):
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_layout(name, t, q.device)
    b, h, lq, dh = q.shape
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"the CUDA kernels take head widths up to "
                         f"{MAX_HEAD_DIM}; got {dh}")
    if k.shape[:2] != (b, h) or k.shape[3] != dh or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if lq < 1 or k.shape[2] < 1:
        raise ValueError("flash attention needs at least one query and one "
                         "key")
    if bias is not None and (
            bias.dtype != torch.float32 or bias.device != q.device
            or tuple(bias.shape) != (b, k.shape[2])
            or not bias.is_contiguous()):
        raise ValueError(f"bias must be contiguous f32 (B, Lk) = "
                         f"{(b, k.shape[2])} on q's device; got {bias.dtype} "
                         f"{tuple(bias.shape)}")


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.sais_cuda_error_string.argtypes = [ctypes.c_int]
    lib.sais_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """K2's built library with its C signature declared (first call
    builds)."""
    from sais_tpu_torch.kernels import _build
    lib = _declare(_build.load("flash_attention"))
    lib.flash_attention_fwd.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
        + [ctypes.c_longlong] * 12
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.flash_attention_fwd.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    """K3's built library with its C signature declared (first call
    builds)."""
    from sais_tpu_torch.kernels import _build
    lib = _declare(_build.load("flash_attention_bwd"))
    lib.flash_attention_bwd.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
        + [ctypes.c_longlong] * 21 + [ctypes.c_float, ctypes.c_void_p])
    lib.flash_attention_bwd.restype = ctypes.c_int
    return lib


def _raise_on(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} CUDA launch failed: "
                           + lib.sais_cuda_error_string(rc).decode())


def _require_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"flash attention: no kernel for {t.device}")


def _launch(q, k, v, bias, zero_masked_rows: bool):
    """One launch of K2; counted in `flash_attention.launches`.  Operands
    the row rule does not take are packed first (`_padded`)."""
    _check_cuda_args(q, k, v, bias)
    b, h, lq, dh = q.shape
    scale = dh ** -0.5
    if not all(_aligned(t) for t in (q, k, v)):
        q, k, v = (_padded(t) for t in (q, k, v))
        out, lse = _launch_aligned(q, k, v, bias, zero_masked_rows, scale)
        return out[..., :dh], lse
    return _launch_aligned(q, k, v, bias, zero_masked_rows, scale)


def _launch_aligned(q, k, v, bias, zero_masked_rows: bool, scale: float):
    b, h, lq, dh = q.shape
    lk = k.shape[2]
    lib = _lib()
    out = torch.empty((b, lq, h, dh), dtype=torch.float32,
                      device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, h, lq, lk, dh,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], scale, int(zero_masked_rows), stream)
    _raise_on(lib, rc, "flash_attention")
    flash_attention.launches += 1
    return out, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`_run_fwd`'s contract: (out, lse) of masked attention with an
    additive (B, Lk) f32 key bias; Lq and Lk may differ.  No zeroing of
    all-masked elements (their rows average v, as on the TPU).  CUDA
    tensor: K2; CPU tensor: `flash_attention_reference`."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, bias)
    _require_cuda(q)
    return _launch(q, k, v, bias, zero_masked_rows=False)


def _empty_grads(q: torch.Tensor, k: torch.Tensor) -> Grads:
    """dq, dk, dv as (B, H, L, Dh) views of (B, L, H, Dh) buffers."""
    b, h, lq, dh = q.shape
    lk = k.shape[2]
    kw = dict(dtype=torch.float32, device=q.device)
    return (torch.empty((b, lq, h, dh), **kw).transpose(1, 2),
            torch.empty((b, lk, h, dh), **kw).transpose(1, 2),
            torch.empty((b, lk, h, dh), **kw).transpose(1, 2))


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor], out: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor,
                        grads: Optional[Sequence[torch.Tensor]] = None
                        ) -> Grads:
    """`_run_bwd`'s contract: (dq, dk, dv) in f32 from the forward's out and
    row lse (K2's outputs) and the cotangent do (shaped like out).  Lq and
    Lk may differ; `lse` must be the global row logsumexp of the keys
    given.  `grads`, optional: three f32 (B, H, L, Dh) tensors with the
    kernels' layout to write dq, dk and dv into (views of one buffer, for
    example).  CUDA tensor: K3, both of its kernels, counted once in
    `flash_attention_bwd.launches` (operands the row rule does not take
    are packed first, the gradients copied back); CPU tensor:
    `flash_attention_bwd_reference`."""
    if q.device.type == "cpu":
        got = flash_attention_bwd_reference(q, k, v, bias, out, lse, do)
        if grads is None:
            return got
        for dst, src in zip(grads, got):
            dst.copy_(src)
        return tuple(grads)
    _require_cuda(q)
    _check_cuda_args(q, k, v, bias)
    if do.shape != q.shape or out.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} and out {tuple(out.shape)} "
                         f"must match q {tuple(q.shape)}")
    _check_layout("do", do, q.device)
    b, h, lq, dh = q.shape
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, lq)
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"lse must be contiguous f32 (B, H, Lq) = "
                         f"{(b, h, lq)}; got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    dq, dk, dv = _empty_grads(q, k) if grads is None else grads
    for name, g, like in (("dq", dq, q), ("dk", dk, k), ("dv", dv, v)):
        if g.shape != like.shape:
            raise ValueError(f"{name} {tuple(g.shape)} does not match "
                             f"{tuple(like.shape)}")
        _check_layout(name, g, q.device)
    delta = _delta(out, do)
    scale = dh ** -0.5
    if not all(_aligned(t) for t in (q, k, v, do, dq, dk, dv)):
        qp, kp, vp, dop = (_padded(t) for t in (q, k, v, do))
        packed = _bwd_aligned(qp, kp, vp, bias, dop, lse, delta,
                              _empty_grads(qp, kp), scale)
        for dst, src in zip((dq, dk, dv), packed):
            dst.copy_(src[..., :dh])
        return dq, dk, dv
    return _bwd_aligned(q, k, v, bias, do, lse, delta, (dq, dk, dv), scale)


def _bwd_aligned(q, k, v, bias, do, lse, delta, grads, scale: float
                 ) -> Grads:
    """One launch of K3 on operands that keep the row rule."""
    b, h, lq, dh = q.shape
    lk = k.shape[2]
    dq, dk, dv = grads
    lib = _bwd_lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, h, lq, lk, dh,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *do.stride()[:3], *dq.stride()[:3], *dk.stride()[:3],
            *dv.stride()[:3], scale, stream)
    _raise_on(lib, rc, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


def _attention_fwd(q, k, v, bias, zero_masked: bool):
    """(out, lse); with `zero_masked`, all-masked elements give zeros."""
    if q.device.type == "cpu":
        out, lse = flash_attention_reference(q, k, v, bias)
        if zero_masked:
            out = out * _any_valid(bias)
        return out, lse
    _require_cuda(q)
    return _launch(q, k, v, bias, zero_masked_rows=zero_masked)


def _attention_bwd(q, k, v, bias, out, lse, do, zero_masked: bool,
                   grads=None) -> Grads:
    if zero_masked:
        # out = out_core * any_valid: the cotangent of an all-masked
        # element is zero, so its dq, dk and dv are exactly 0 (JAX's
        # multiply at flash_attention.py:504 does the same)
        do = do * _any_valid(bias)
    if do.stride(-1) != 1 or any(s % 4 for s in do.stride()[:3]):
        do = do.contiguous()    # e.g. a cotangent broadcast from a sum
    return flash_attention_bwd(q, k, v, bias, out, lse, do, grads)


class FlashAttention(torch.autograd.Function):
    """Differentiable masked attention: forward K2, backward K3 (their
    plain versions for CPU tensors).  apply(q, k, v, bias, zero_masked):
    q (B, H, Lq, Dh), k and v (B, H, Lk, Dh), bias (B, Lk) f32 or None;
    zero_masked gives all-masked elements zeros (`flash_attention`)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, zero_masked):
        out, lse = _attention_fwd(q, k, v, bias, zero_masked)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.zero_masked = zero_masked
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, out, lse = ctx.saved_tensors
        dq, dk, dv = _attention_bwd(q, k, v, bias, out, lse, do,
                                    ctx.zero_masked)
        return dq, dk, dv, None, None


def split_heads(qkv: torch.Tensor, num_heads: int) -> Grads:
    """(B, L, 3 D) projection -> q, k, v as (B, H, L, Dh) views."""
    b, l, d3 = qkv.shape
    return qkv.view(b, l, 3, num_heads, d3 // (3 * num_heads)).permute(
        2, 0, 3, 1, 4).unbind(0)


class PackedFlashAttention(torch.autograd.Function):
    """`FlashAttention` over the heads of one (B, L, 3 D) projection:
    apply(qkv, num_heads, bias, zero_masked) -> out (B, H, L, Dh).  The
    backward writes dq, dk and dv through strides into one (B, L, 3 D)
    buffer, the projection's gradient as F.linear's backward reads it."""

    @staticmethod
    def forward(ctx, qkv, num_heads, bias, zero_masked):
        q, k, v = split_heads(qkv, num_heads)
        out, lse = _attention_fwd(q, k, v, bias, zero_masked)
        ctx.save_for_backward(qkv, bias, out, lse)
        ctx.num_heads, ctx.zero_masked = num_heads, zero_masked
        return out

    @staticmethod
    def backward(ctx, do):
        qkv, bias, out, lse = ctx.saved_tensors
        dqkv = torch.empty(qkv.shape, dtype=qkv.dtype, device=qkv.device)
        _attention_bwd(*split_heads(qkv, ctx.num_heads), bias, out, lse, do,
                       ctx.zero_masked, grads=split_heads(dqkv, ctx.num_heads))
        return dqkv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_padding_mask: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Masked multi-head attention without materializing (L, L) weights.

    q, k, v: (B, H, L, Dh); key_padding_mask: (B, L) bool, True = pad.
    Returns (B, H, L, Dh) in q's dtype; a batch element whose keys are all
    masked gets zeros.  Differentiable (`FlashAttention`).  CUDA tensor:
    K2 forward and K3 backward (f32 only, counted in
    `flash_attention.launches` and `flash_attention_bwd.launches`); CPU
    tensor: the plain versions."""
    bias = None if key_padding_mask is None else key_bias(key_padding_mask)
    return FlashAttention.apply(q, k, v, bias, bias is not None)


flash_attention.launches = 0


def flash_attention_packed(qkv: torch.Tensor, num_heads: int,
                           key_padding_mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """`flash_attention` on the q, k, v heads of one (B, L, 3 D) projection
    (`PackedFlashAttention`), as the temporal encoder calls it."""
    bias = None if key_padding_mask is None else key_bias(key_padding_mask)
    return PackedFlashAttention.apply(qkv, num_heads, bias, bias is not None)


def cls_attention_row(q: torch.Tensor, k: torch.Tensor,
                      key_padding_mask: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Head-averaged attention of the CLS query (row 0), the quantity SAIS
    exports (prepare_model.py:221).  O(L) per window, plain PyTorch.
    q, k: (B, H, L, Dh) -> (B, L)."""
    dh = q.shape[-1]
    q0 = q[:, :, 0, :].float() * dh ** -0.5
    logits = torch.einsum("bhd,bhld->bhl", q0, k.float())
    if key_padding_mask is not None:
        logits = torch.where(key_padding_mask[:, None, :], _NEG_INF, logits)
    return torch.softmax(logits, dim=-1).mean(dim=1)
