"""K2: masked flash-attention forward (out and row logsumexp), f32.

Counterpart of `sais_tpu/kernels/flash_attention.py` (`flash_attention`
-> `_run_fwd` -> Pallas body `_flash_fwd_kernel`).  For a CUDA tensor the
wrappers launch the hand-written kernel of `csrc/flash_attention.cu`; for
a CPU tensor they run the plain PyTorch version `flash_attention_reference`.
Neither falls back from one to the other.

Semantics kept from the JAX kernel:

- the query is pre-scaled once in f32 (q * Dh**-0.5);
- masked keys get an additive f32 bias of -1e30 (not -inf), and the
  online-softmax state starts at m = -1e30, so no inf - inf arises;
- out = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30));
- `flash_attention` gives zeros for every row of a batch element whose
  keys are all masked (flash_attention.py:496-504).

The JAX package pads L to its block sizes and Dh to 128 lanes, and splits
long K/V into VMEM-sized chunks; those are TPU tiling choices that change
no value.  The CUDA kernel runs exact shapes (the ragged key tile is
masked inside it) and streams K/V from device memory, so it has no length
ceiling.  It takes strides: q, k and v may be (B, H, L, Dh) views of the
temporal encoder's (B, L, 3 D) projection, and the output is written into
a (B, L, H, Dh) buffer and returned as its (B, H, L, Dh) view, so the
encoder transposes nothing either way.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

_NEG_INF = -1e30
HEAD_DIMS = (64, 96, 128)   # the head widths the CUDA kernel is built for


def key_bias(key_padding_mask: torch.Tensor) -> torch.Tensor:
    """(B, L) bool, True = pad -> (B, L) f32 additive bias, 0 or -1e30."""
    return torch.where(key_padding_mask, _NEG_INF, 0.0).float()


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


def _check_cuda_args(q, k, v, bias):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4 or t.dtype != torch.float32:
            raise ValueError(f"flash_attention on CUDA takes f32 (B, H, L, "
                             f"Dh); {name} is {t.dtype} {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError("all K2 operands must be on q's device")
        if t.stride(-1) != 1 or any(s % 4 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: K2 takes a contiguous last axis and "
                             "16-byte aligned rows (strides in multiples of "
                             "4 elements)")
    b, h, lq, dh = q.shape
    if dh not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head dim {HEAD_DIMS}; "
                         f"got {dh}")
    if k.shape[:2] != (b, h) or k.shape[3] != dh or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if lq < 1 or k.shape[2] < 1:
        raise ValueError("K2 needs at least one query and one key")
    if bias is not None and (
            bias.dtype != torch.float32 or bias.device != q.device
            or tuple(bias.shape) != (b, k.shape[2])
            or not bias.is_contiguous()):
        raise ValueError(f"bias must be contiguous f32 (B, Lk) = "
                         f"{(b, k.shape[2])} on q's device; got {bias.dtype} "
                         f"{tuple(bias.shape)}")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (first call builds)."""
    from sais_tpu_torch.kernels import _build
    lib = _build.load("flash_attention")
    lib.flash_attention_fwd.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
        + [ctypes.c_longlong] * 12
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.flash_attention_fwd.restype = ctypes.c_int
    lib.sais_cuda_error_string.argtypes = [ctypes.c_int]
    lib.sais_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(q, k, v, bias, zero_masked_rows: bool):
    """One launch of the CUDA kernel; counted in `flash_attention.launches`."""
    _check_cuda_args(q, k, v, bias)
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
            *out.stride()[:3], dh ** -0.5, int(zero_masked_rows), stream)
    if rc != 0:
        raise RuntimeError("flash_attention CUDA launch failed: "
                           + lib.sais_cuda_error_string(rc).decode())
    flash_attention.launches += 1
    return out, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`_run_fwd`'s contract: (out, lse) of masked attention with an
    additive (B, Lk) f32 key bias; Lq and Lk may differ.  No zeroing of
    all-masked elements (their rows average v, as on the TPU).  CUDA
    tensor: the kernel; CPU tensor: `flash_attention_reference`."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    return _launch(q, k, v, bias, zero_masked_rows=False)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_padding_mask: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Masked multi-head attention without materializing (L, L) weights.

    q, k, v: (B, H, L, Dh); key_padding_mask: (B, L) bool, True = pad.
    Returns (B, H, L, Dh) in q's dtype; a batch element whose keys are all
    masked gets zeros.  CUDA tensor: the kernel (f32 only, counted in
    `flash_attention.launches`); CPU tensor: the plain version."""
    bias = None if key_padding_mask is None else key_bias(key_padding_mask)
    if q.device.type == "cpu":
        out, _ = flash_attention_reference(q, k, v, bias)
        if key_padding_mask is not None:
            any_valid = ~key_padding_mask.all(-1)
            out = out * any_valid.to(out.dtype)[:, None, None, None]
        return out
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    out, _ = _launch(q, k, v, bias, zero_masked_rows=bias is not None)
    return out


flash_attention.launches = 0


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
