"""K7: the DINO head's weight-normed last layer and the DINO loss with
their gradients, tiled over out_dim so that the (rows, out_dim) logits
never reach device memory.

Counterpart of `sais_tpu/kernels/dino_head_loss.py`
(`_fused_loss_and_grads`, Pallas bodies `_stats_kernel` and
`_grad_kernel`).  Reference semantics (dino-main/main_dino.py:581-634 and
vision_transformer.py:257-291): student logits l = h_s @ (v / ||v||) (g
applied only when norm_last_layer=False), teacher probabilities q =
softmax((l_t - center) / temp_t), loss = mean over the crop pairs (iq, v),
v != iq, of -q_iq . log_softmax(l_v / temp_s).  The pair structure is a
constant selection matrix S (rows_s, rows_t) and pair counts c = S @ 1
(`build_pair_structure`): qbar = S @ q.

Gradients (p = softmax(s), s = l / temp_s):
  dl   = bf16((c * p - qbar) / (temp_s * B * n_terms))
  dh_s = dl @ w^T;  dw = h_s^T @ dl
  dv   = (du - u (u . du)) / ||v||, u = v / ||v||, du = dw * g and
         dg = u . dw when norm_last_layer=False (else du = dw, dg = 0).
The teacher inputs get no gradient.

`fused_loss_and_grads` launches the CUDA kernel (`csrc/dino_head_loss.cu`:
every product on the wgmma + TMA GEMM of `csrc/gemm_sm90.cuh`, dl stored
once in bf16) for CUDA tensors, counted in its `.launches`, and runs the
plain version `fused_loss_and_grads_reference` for CPU tensors; it never
falls back from one to the other.  The TPU kernel's 8-row padding and its
rescaled center are MXU tiling choices: the port takes exact shapes, and
the center is the mean over the real teacher rows.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

# Bottleneck widths the CUDA kernel takes (csrc/dino_head_loss.cu).
BOTTLENECKS = (128, 256)


def build_pair_structure(batch: int, n_global: int,
                         n_local: int) -> Tuple[np.ndarray, np.ndarray]:
    """Selection matrix S (rows_s, rows_t) and pair counts c (rows_s, 1).

    Rows are image-major ([img0 crop0, img0 crop1, ...], the layout of
    `ops.augment.multi_crop_batch`): student row r of the global group is
    (img, crop) = divmod(r, n_global), of the local group (img, n_global +
    crop) = divmod(r - n_global * batch, n_local).  S[r, t] = 1 iff teacher
    row t shares r's image and its crop index differs (the v != iq
    exclusion, main_dino.py:610-612)."""
    rows_s = (n_global + n_local) * batch
    rows_t = n_global * batch
    s = np.zeros((rows_s, rows_t), np.float32)
    for r in range(rows_s):
        if r < n_global * batch:
            img, v = divmod(r, n_global)
        else:
            img, v = divmod(r - n_global * batch, n_local)
            v += n_global
        for iq in range(n_global):
            if iq != v:
                s[r, img * n_global + iq] = 1.0
    return s, s.sum(axis=1, keepdims=True).astype(np.float32)


def normed_w(v: torch.Tensor, g: torch.Tensor, use_g: bool):
    """(w, u, n): u = v / ||v||_col with the norm clamped at 1e-12 (a
    collapsed column gives zeros, not NaNs), w = u [* g], all float32.  The
    sum of squares runs in float64, as the kernel's does, so both get the
    correctly rounded f32 norm and round w to bf16 identically."""
    v = v.float()
    n = torch.clamp(torch.sqrt((v.double() ** 2).sum(0, keepdim=True))
                    .float(), min=1e-12)
    u = v / n
    return (u * g.float().reshape(1, -1) if use_g else u), u, n


def _check_out_dim(k: int) -> None:
    if k % 128:
        raise ValueError(f"out_dim {k} must be a multiple of 128 for the "
                         "fused DINO loss (use fused_loss=False otherwise)")


def _lse(x: torch.Tensor) -> torch.Tensor:
    """Row logsumexp as the kernels form it: m + log(max(sum exp(x - m),
    1e-30))."""
    m = x.max(-1, keepdim=True).values
    return m + torch.log(torch.clamp(torch.exp(x - m).sum(-1, keepdim=True),
                                     min=1e-30))


def fused_loss_and_grads_reference(hs, ht, vs, vt, gs, gt, center, temp_t,
                                   sel, c, *, student_temp: float,
                                   inv_norm: float, use_g: bool):
    """Plain PyTorch version of K7: (loss, batch_center, dhs, dvs, dgs),
    the gradients of the loss with respect to hs (rs, db), vs (db, K) and
    gs (K,), all float32 at exact shapes.  Rounding points of the Pallas
    bodies: hs, ht and w rounded to bf16 for every product (f32
    accumulation), dl rounded to bf16 before both of its products; p, q,
    qbar = sel @ q, the statistics and the loss in float32."""
    _check_out_dim(vs.shape[1])
    inv_ts = 1.0 / student_temp
    dev = hs.device
    hs = hs.to(torch.bfloat16).float()
    ht = ht.to(torch.bfloat16).float()
    ws, us, ns = normed_w(vs, gs, use_g)
    wsb = ws.to(torch.bfloat16).float()
    wtb = normed_w(vt, gt, use_g)[0].to(torch.bfloat16).float()
    inv_tt = 1.0 / torch.as_tensor(temp_t, dtype=torch.float32,
                                   device=dev).reshape(1, 1)
    sel, c = sel.float(), c.float().reshape(-1, 1)

    s = torch.matmul(hs, wsb) * inv_ts
    lse_s = _lse(s)
    tl = torch.matmul(ht, wtb)
    batch_center = tl.mean(0)
    ts = (tl - center.float().reshape(1, -1)) * inv_tt
    q = torch.exp(ts - _lse(ts))
    qbar = torch.matmul(sel, q)
    loss = ((-qbar * s).sum() + (c * lse_s).sum()) * inv_norm
    p = torch.exp(s - lse_s)
    dl = ((c * p - qbar) * (inv_ts * inv_norm)).to(torch.bfloat16).float()
    dhs = torch.matmul(dl, wsb.t())
    dw = torch.matmul(hs.t(), dl)
    if use_g:
        dgs = (us * dw).sum(0)
        du = dw * gs.float().reshape(1, -1)
    else:
        dgs = torch.zeros(vs.shape[1], dtype=torch.float32, device=dev)
        du = dw
    dvs = (du - us * (us * du).sum(0, keepdim=True)) / ns
    return loss, batch_center, dhs, dvs, dgs


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built K7 library with its C signatures (first call builds)."""
    from sais_tpu_torch.kernels import _build
    lib = _build.load("dino_head_loss")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dino_head_loss_workspace.argtypes = [i32] * 4
    lib.dino_head_loss_workspace.restype = ctypes.c_size_t
    lib.dino_head_loss_offsets.argtypes = [i32] * 4 + [ptr]
    lib.dino_head_loss_offsets.restype = None
    lib.dino_head_loss.argtypes = ([ptr] * 16 + [i32] * 5 + [f32] * 3
                                   + [ptr])
    lib.dino_head_loss.restype = i32
    lib.sais_cuda_error_string.argtypes = [i32]
    lib.sais_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _cuda_operand(t, name, shape, dtype):
    """t as the kernel takes it: `dtype`, contiguous, of `shape`."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"K7 {name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.device.type != "cuda":
        raise ValueError(f"K7 {name} is on {t.device}; every operand must "
                         "be on the card")
    if not t.is_floating_point():
        raise ValueError(f"K7 {name}: floating-point operand expected, got "
                         f"{t.dtype}")
    return t.to(dtype).contiguous()


def _run_kernel(hs, ht, vs, vt, gs, gt, center, temp_t, sel, c, *,
                student_temp, inv_norm, use_g):
    """One launch of the CUDA kernel: ((loss, batch_center, dhs, dvs, dgs),
    its f32 workspace)."""
    rs, db = hs.shape
    rt, k = ht.shape[0], vs.shape[1]
    if db not in BOTTLENECKS:
        raise ValueError(f"K7 takes bottleneck widths {BOTTLENECKS}; got "
                         f"{db}")
    if rs < 1 or rt < 1:
        raise ValueError(f"K7 needs student and teacher rows; got {rs}, {rt}")
    f32, bf = torch.float32, torch.bfloat16
    hs = _cuda_operand(hs, "hs", (rs, db), bf)
    ht = _cuda_operand(ht, "ht", (rt, db), bf)
    vs = _cuda_operand(vs, "vs", (db, k), f32)
    vt = _cuda_operand(vt, "vt", (db, k), f32)
    gs = _cuda_operand(gs.reshape(-1), "gs", (k,), f32)
    gt = _cuda_operand(gt.reshape(-1), "gt", (k,), f32)
    center = _cuda_operand(center.reshape(-1), "center", (k,), f32)
    sel = _cuda_operand(sel, "sel", (rs, rt), f32)
    c = _cuda_operand(c.reshape(-1), "c", (rs,), f32)
    dev = hs.device
    if isinstance(temp_t, torch.Tensor):
        tt = _cuda_operand(temp_t.reshape(-1), "temp_t", (1,), f32)
    else:
        tt = torch.full((1,), float(temp_t), dtype=f32, device=dev)
    lib = _lib()
    loss = torch.empty((), dtype=f32, device=dev)
    bc = torch.empty((k,), dtype=f32, device=dev)
    dhs = torch.empty((rs, db), dtype=f32, device=dev)
    dvs = torch.empty((db, k), dtype=f32, device=dev)
    dgs = torch.empty((k,), dtype=f32, device=dev)
    workspace = torch.empty(
        (lib.dino_head_loss_workspace(rs, rt, db, k),), dtype=f32,
        device=dev)
    inv_ts = 1.0 / student_temp
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.dino_head_loss(
            *(t.data_ptr() for t in (hs, ht, vs, vt, gs, gt, center, tt,
                                     sel, c, loss, bc, dhs, dvs, dgs,
                                     workspace)),
            rs, rt, db, k, int(use_g), inv_ts, inv_ts * inv_norm, inv_norm,
            stream)
    if rc != 0:
        raise RuntimeError("K7 CUDA launch failed: "
                           + lib.sais_cuda_error_string(rc).decode())
    return (loss, bc, dhs, dvs, dgs), workspace


def fused_loss_and_grads(hs, ht, vs, vt, gs, gt, center, temp_t, sel, c, *,
                         student_temp: float, inv_norm: float, use_g: bool):
    """K7: (loss, batch_center, dhs, dvs, dgs) as
    `fused_loss_and_grads_reference` defines them.  CUDA tensors: the
    hand-written kernel (counted in `fused_loss_and_grads.launches`); CPU
    tensors: the plain version.  temp_t may be a float or a one-element
    tensor; it is read on the device, so a tensor costs no host sync."""
    _check_out_dim(vs.shape[1])
    if hs.device.type == "cpu":
        return fused_loss_and_grads_reference(
            hs, ht, vs, vt, gs, gt, center, temp_t, sel, c,
            student_temp=student_temp, inv_norm=inv_norm, use_g=use_g)
    if hs.device.type != "cuda":
        raise ValueError(f"fused_loss_and_grads: no kernel for {hs.device}")
    out, _ = _run_kernel(hs, ht, vs, vt, gs, gt, center, temp_t, sel, c,
                         student_temp=student_temp, inv_norm=inv_norm,
                         use_g=use_g)
    fused_loss_and_grads.launches += 1
    return out


fused_loss_and_grads.launches = 0

# Tile width of the kernel's per-row statistics (csrc/gemm_sm90.cuh: BN).
STATS_TILE = 192


def k7_intermediates(hs, ht, vs, vt, gs, gt, center, temp_t, sel, c, *,
                     student_temp: float, inv_norm: float, use_g: bool):
    """The card tests' view of K7's epilogues: one launch of the kernel on
    CUDA tensors (counted in `k7_intermediates.launches`) and, read from
    its workspace, the student's and the teacher's per-(row, 192-column
    tile) max and sum exp ("ms", "ls", "mt", "lt", each (rows, tiles)),
    "lse_s" (rs,), the teacher probabilities "q" (rt, k) f32 and "dl"
    (rs, k) bf16, beside its outputs ("out")."""
    if hs.device.type != "cuda":
        raise ValueError("k7_intermediates reads the CUDA kernel's "
                         "workspace; it takes CUDA tensors only")
    _check_out_dim(vs.shape[1])
    out, ws = _run_kernel(hs, ht, vs, vt, gs, gt, center, temp_t, sel, c,
                          student_temp=student_temp, inv_norm=inv_norm,
                          use_g=use_g)
    k7_intermediates.launches += 1
    rs, db = hs.shape
    rt, k = ht.shape[0], vs.shape[1]
    tiles = -(-k // STATS_TILE)
    offsets = (ctypes.c_size_t * 7)()
    _lib().dino_head_loss_offsets(rs, rt, db, k, offsets)
    views = {}
    for name, o, shape in zip(
            ("ms", "ls", "mt", "lt", "lse_s", "q"), offsets,
            ((rs, tiles), (rs, tiles), (rt, tiles), (rt, tiles), (rs,),
             (rt, k))):
        views[name] = ws[o:o + int(np.prod(shape))].view(shape)
    dl = ws[offsets[6]:].view(torch.bfloat16)[:rs * k]
    views["dl"] = dl.view(rs, k)
    views["out"] = out
    return views


k7_intermediates.launches = 0


class FusedDinoLoss(torch.autograd.Function):
    """Last layer + DINO loss with a free backward (JAX
    `make_fused_dino_loss`'s custom VJP): the forward runs both passes and
    keeps dhs, dvs and dgs; the backward scales them by the loss
    cotangent.  The teacher inputs, the center, the temperature and the
    pair structure get no gradient; the batch center is not
    differentiable.

    apply(student_temp, inv_norm, use_g, hs, vs, gs, ht, vt, gt, center,
    temp_t, sel, c) -> (loss, batch_center)."""

    @staticmethod
    def forward(ctx, student_temp, inv_norm, use_g, hs, vs, gs, ht, vt, gt,
                center, temp_t, sel, c):
        loss, bc, dhs, dvs, dgs = fused_loss_and_grads(
            hs.detach(), ht.detach(), vs.detach(), vt.detach(), gs.detach(),
            gt.detach(), center.detach(), temp_t, sel, c,
            student_temp=student_temp, inv_norm=inv_norm, use_g=use_g)
        ctx.save_for_backward(dhs.to(hs.dtype), dvs.to(vs.dtype),
                              dgs.to(gs.dtype))
        ctx.mark_non_differentiable(bc)
        return loss, bc

    @staticmethod
    def backward(ctx, gloss, _gbc):
        dhs, dvs, dgs = ctx.saved_tensors
        return (None, None, None, gloss * dhs, gloss * dvs, gloss * dgs,
                None, None, None, None, None, None, None)


def make_fused_dino_loss(student_temp: float, batch: int, n_global: int,
                         n_crops: int, norm_last_layer: bool = True):
    """fn(hs, vs, gs, ht, vt, gt, center, temp_t, sel, c) -> (loss,
    batch_center), with the JAX factory's signature and argument order:
    hs / ht the L2-normalized bottleneck outputs (`dino_head_bottleneck`),
    vs / gs the student's last layer, vt / gt the teacher's, (sel, c) from
    `build_pair_structure`.  Gradients reach hs, vs and (norm_last_layer
    False) gs only."""
    inv_norm = 1.0 / (batch * n_global * (n_crops - 1))
    use_g = not norm_last_layer

    def op(hs, vs, gs, ht, vt, gt, center, temp_t, sel, c):
        return FusedDinoLoss.apply(student_temp, inv_norm, use_g, hs, vs, gs,
                                   ht, vt, gt, center, temp_t, sel, c)

    return op


def make_fused_dino_loss_dp(student_temp: float, local_batch: int,
                            n_global: int, n_crops: int, total, n_shards: int,
                            norm_last_layer: bool = True):
    """The data-parallel fused last layer + loss (JAX
    `make_fused_dino_loss_dp`, dino_head_loss.py:333-400): K7 runs on this
    rank's images (whole images, image-major, the pair structure of
    `local_batch` images), normalized by the global batch, and

      loss   = total(local pair-CE sums) / (global_B * n_terms)
      center = total(local teacher-row means) / n_shards

    with `total` a sum over the batch's shards (`DataParallel.total`),
    whose backward all-reduces the cotangent: K7's dh_s stays local, its
    dv and dg are this rank's shares, summed with the other gradients by
    `all_reduce_grads`.  No kernel of its own.  Same signature as
    `make_fused_dino_loss`'s op."""
    inv_norm = 1.0 / (local_batch * n_shards * n_global * (n_crops - 1))
    use_g = not norm_last_layer

    def op(hs, vs, gs, ht, vt, gt, center, temp_t, sel, c):
        loss, batch_center = FusedDinoLoss.apply(
            student_temp, inv_norm, use_g, hs, vs, gs, ht, vt, gt, center,
            temp_t, sel, c)
        return total(loss), total(batch_center.detach()) / n_shards

    return op
