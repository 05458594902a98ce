"""The 3xTF32 split that K2 and K3 (csrc/flash_attention.cu,
csrc/flash_attention_bwd.cu, csrc/flash_tf32.cuh) run their f32 products
with, emulated in PyTorch on the CPU and held against the JAX package's
flash kernels (`_run_fwd` / `_run_bwd` in interpret mode) at the card's
limits.  A second case shows why the split is needed: one TF32 pass errs at
least ten times more.

The emulation follows the kernels' arithmetic: x_big is x rounded to TF32
(cvt.rna.tf32.f32: add 0x1000 to the f32 bit pattern, mask with
0xFFFFE000), x_small = x - x_big is exact and the tensor core reads only its
TF32 bits (the low 13 are cut off), and a product sums a_small b_big +
a_big b_small + a_big b_big in f32.  The TF32 products themselves are exact
in f32, so f32 einsums of the parts reproduce them."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sais_tpu.kernels import flash_attention as jfa
from tests.test_torch_flash_bwd import _padded_like_jax

_TF32_MASK = -0x2000   # 0xFFFFE000 as an int32


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 of finite f32 values: round to the 11 significant
    bits of TF32, ties away from zero."""
    return ((x.view(torch.int32) + 0x1000) & _TF32_MASK).view(torch.float32)


def tf32_bits(x: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of an f32 register: its TF32 bits."""
    return (x.view(torch.int32) & _TF32_MASK).view(torch.float32)


def mm_3xtf32(spec, a, b):
    a_big, b_big = rna_tf32(a), rna_tf32(b)
    a_small, b_small = tf32_bits(a - a_big), tf32_bits(b - b_big)
    return ((torch.einsum(spec, a_small, b_big)
             + torch.einsum(spec, a_big, b_small))
            + torch.einsum(spec, a_big, b_big))


def mm_tf32(spec, a, b):
    """One TF32 pass, the product the split replaces."""
    return torch.einsum(spec, rna_tf32(a), rna_tf32(b))


def mm_exact(spec, a, b):
    return torch.einsum(spec, a, b)


def fwd(q, k, v, bias, mm):
    """K2's formulas with the products taken by `mm`: (out, lse)."""
    s = mm("bhld,bhmd->bhlm", q * q.shape[-1] ** -0.5, k)
    s = s + bias[:, None, None, :]
    m = s.amax(-1, keepdim=True).clamp_min(-1e30)
    p = torch.exp(s - m)
    l_safe = p.sum(-1, keepdim=True).clamp_min(1e-30)
    return mm("bhlm,bhmd->bhld", p, v) / l_safe, (m + torch.log(l_safe))[..., 0]


def bwd(q, k, v, bias, out, lse, do, mm):
    """K3's formulas with the products taken by `mm`: (dq, dk, dv)."""
    scale = q.shape[-1] ** -0.5
    qs = q * scale
    s = mm("bhld,bhmd->bhlm", qs, k) + bias[:, None, None, :]
    p = torch.exp(s - lse[..., None])
    dp = mm("bhld,bhmd->bhlm", do, v)
    ds = p * (dp - (do * out).sum(-1)[..., None])
    return (mm("bhlm,bhmd->bhld", ds, k) * scale,
            mm("bhlm,bhld->bhmd", ds, qs), mm("bhlm,bhld->bhmd", p, do))


def _inputs(b, h, l, dh, seed):
    """q, k, v, dO from a numpy seed; element i has its last 7 + 11 i keys
    masked (bias -1e30)."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((b, h, l, dh)).astype(np.float32)
                   for _ in range(4))
    bias = np.zeros((b, l), np.float32)
    for i in range(b):
        bias[i, l - 7 - 11 * i:] = -1e30
    return q, k, v, do, bias


def _close(got, ref, name, floor=0.0):
    """max|got - ref| <= 1e-4 * max(floor, max|ref|), the card's limits."""
    ref = np.asarray(ref)
    err = np.abs(got.numpy() - ref).max()
    limit = 1e-4 * max(floor, np.abs(ref).max())
    assert err <= limit, f"{name}: {err} > {limit}"


@pytest.mark.parametrize("b,h,l,dh", [(2, 2, 130, 64), (1, 2, 301, 96)])
def test_split_meets_the_card_limits_against_jax(b, h, l, dh):
    """K2 and K3's formulas in emulated 3xTF32 against `_run_fwd` and
    `_run_bwd` (interpret mode) on inputs padded as `flash_attention` pads
    them: out, dq, dk, dv within 1e-4 of the largest JAX value, lse within
    1e-4 of max(1, |lse|), the limits chip_smoke.py holds the kernels to."""
    q, k, v, do, bias = _inputs(b, h, l, dh, seed=l)
    (qp, kp, vp, dop), bp, lp = _padded_like_jax((q, k, v, do), bias, l)
    j = [jnp.asarray(x) for x in (qp, kp, vp, bp)]
    scale = dh ** -0.5
    jout, jlse = jfa._run_fwd(*j, scale, lp, lp, True)
    jgrads = jfa._run_bwd(*j, jout, jlse, jnp.asarray(dop), scale, lp, lp,
                          True)
    t = [torch.from_numpy(x) for x in (q, k, v, bias)]
    out, lse = fwd(*t, mm_3xtf32)
    _close(out, np.asarray(jout)[:, :, :l, :dh], "out")
    _close(lse, np.asarray(jlse)[:, :, :l], "lse", floor=1.0)
    grads = bwd(*t, out, lse, torch.from_numpy(do), mm_3xtf32)
    for name, g, r in zip(("dq", "dk", "dv"), grads, jgrads):
        _close(g, np.asarray(r)[:, :, :l, :dh], name)


def test_one_tf32_pass_errs_ten_times_more_than_the_split():
    """At (1, 2, 1030, 96), against K2's and K3's formulas in float64: one
    TF32 pass errs at least 10x more than the 3xTF32 split on out, dq, dk
    and dv.  This is why the kernels take three products for one."""
    q, k, v, do, bias = (torch.from_numpy(x)
                         for x in _inputs(1, 2, 1030, 96, seed=7))
    x64 = [x.double() for x in (q, k, v, bias)]
    out64, lse64 = fwd(*x64, mm_exact)
    ref = [out64, *bwd(*x64, out64, lse64, do.double(), mm_exact)]

    def errors(mm):
        out, lse = fwd(q, k, v, bias, mm)
        got = [out, *bwd(q, k, v, bias, out, lse, do, mm)]
        return [(g.double() - r).abs().max().item()
                for g, r in zip(got, ref)]

    split, single = errors(mm_3xtf32), errors(mm_tf32)
    for name, e3, e1 in zip(("out", "dq", "dk", "dv"), split, single):
        assert e1 >= 10 * e3, f"{name}: one pass {e1}, split {e3}"
