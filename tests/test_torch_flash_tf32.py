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

import functools

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


# --- the card's order of operations, step by step -------------------------
#
# The kernels sum every f32 product in k-steps of 8: the tensor core adds
# a k-step's three TF32 products into a fragment that starts at zero,
# truncating toward zero (modelled here as one truncation per mma.sync
# instruction of the exact sum), and the part is then rounded into the
# running sum in f32 round-to-nearest, `unbias`ed first where the sum is
# tied (flash_tf32.cuh: mma3).  K2's P V runs on f32 FFMA, keys in order.

_EXP_MASK = -0x800000   # 0xFF800000 as an int32: sign and exponent


def _trunc_f32(x: torch.Tensor) -> torch.Tensor:
    """float64 x rounded toward zero to f32."""
    r = x.float()
    over = r.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def _unbias(t: torch.Tensor) -> torch.Tensor:
    """flash_tf32.cuh's unbias: t plus half an ulp with t's sign, rounded
    to nearest (the half ulp is exact)."""
    half = (t.view(torch.int32) & _EXP_MASK).view(torch.float32) * 2.0 ** -24
    return half + t


def kstep_sum(spec: str, a: torch.Tensor, b: torch.Tensor, tie: bool,
              axis_a: int, axis_b: int) -> torch.Tensor:
    """einsum(spec, a, b) in f32 as a kernel runs it: the contracted axis
    (axis_a of a, axis_b of b) in k-steps of 8 from its start, zero-padded
    to a multiple of 8; each k-step's part the tensor core's three TF32
    products, truncated at each, then (tie) unbias'ed and added in f32."""
    n = a.shape[axis_a]
    pad = -n % 8
    if pad:
        a = torch.nn.functional.pad(a.movedim(axis_a, -1), (0, pad)).movedim(
            -1, axis_a)
        b = torch.nn.functional.pad(b.movedim(axis_b, -1), (0, pad)).movedim(
            -1, axis_b)
    a_big, b_big = rna_tf32(a), rna_tf32(b)
    a_small, b_small = tf32_bits(a - a_big), tf32_bits(b - b_big)
    c = None
    for k0 in range(0, n + pad, 8):
        ia = [slice(None)] * a.dim()
        ib = [slice(None)] * b.dim()
        ia[axis_a] = ib[axis_b] = slice(k0, k0 + 8)
        parts = ((a_small, b_big), (a_big, b_small), (a_big, b_big))
        t = None
        for x, y in parts:
            prod = torch.einsum(spec, x[tuple(ia)].double(),
                                y[tuple(ib)].double())
            t = _trunc_f32(prod if t is None else t.double() + prod)
        t = _unbias(t) if tie else t
        c = t if c is None else c + t
    return c


def _k2_pv_order_shuffled():
    """Keys of a 32-key tile in the order the P V loop that took each p
    from its quad by shuffle visited them for one output: n-tile n, source
    lane src, column c."""
    return [8 * n + 2 * src + c for n in range(4) for src in range(4)
            for c in range(2)]


def _k2_pv_order_card():
    """The same for the redesigned P V (flash_attention.cu pv_step): 4-key
    groups kq, then the key kk of the group."""
    return [4 * kq + kk for kq in range(8) for kk in range(4)]


def k2_card(q, k, v, bias, tile=32):
    """K2 as the card runs it: tied 3xTF32 scores, an online softmax over
    key tiles of 32, and P V on f32 FFMA, keys in order (each FMA
    rounded once: p v is exact in float64).  -> (out, lse)."""
    b, h, lq, dh = q.shape
    lk = k.shape[2]
    qs = q * dh ** -0.5
    m = torch.full((b, h, lq, 1), -1e30)
    l_sum = torch.zeros((b, h, lq, 1))
    acc = torch.zeros((b, h, lq, dh))
    order = _k2_pv_order_card()
    for k0 in range(0, lk, tile):
        kt, vt = k[:, :, k0:k0 + tile], v[:, :, k0:k0 + tile]
        s = kstep_sum("bhld,bhmd->bhlm", qs, kt, True, 3, 3)
        s = s + bias[:, None, None, k0:k0 + tile]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l_sum = l_sum * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha
        for key in order[:kt.shape[2]]:
            acc = (p[..., key:key + 1].double() * vt[:, :, key:key + 1].double()
                   + acc.double()).float()
        m = m_new
    l_safe = l_sum.clamp_min(1e-30)
    return acc / l_safe, (m + torch.log(l_safe))[..., 0]


def k3_card(q, k, v, bias, out, lse, do):
    """K3 as the card runs it, with the partition of its sums over keys
    (dq) and queries (dk, dv) of the width's instance: from Dh 128 one
    running sum over every key (dq) or query (dk, dv) in k-steps of 8
    from the start; up to Dh 96 two running sums a 64-row tile splits
    into (rows 0-31 and 32-63 of every tile), added at the end.  Scores
    tied as K2's, dp untied, the sums over keys and queries tied."""
    dh = q.shape[-1]
    scale = dh ** -0.5
    qs = q * scale
    s = kstep_sum("bhld,bhmd->bhlm", qs, k, True, 3, 3) + bias[:, None, None]
    p = torch.exp(s - lse[..., None])
    dp = kstep_sum("bhld,bhmd->bhlm", do, v, False, 3, 3)
    ds = p * (dp - (do * out).sum(-1)[..., None])

    def partitioned(spec, a, b, axis_a, axis_b):
        n = a.shape[axis_a]
        if dh > 96:
            return kstep_sum(spec, a, b, True, axis_a, axis_b)
        halves = []
        for lo in (0, 32):
            keep = torch.zeros(n, dtype=torch.bool)
            for t0 in range(lo, n, 64):
                keep[t0:t0 + 32] = True
            shape_a = [1] * a.dim()
            shape_a[axis_a] = n
            shape_b = [1] * b.dim()
            shape_b[axis_b] = n
            halves.append(kstep_sum(
                spec, a * keep.view(shape_a), b * keep.view(shape_b), True,
                axis_a, axis_b))
        return halves[0] + halves[1]

    dq = partitioned("bhlm,bhmd->bhld", ds, k, 3, 2) * scale
    dk = partitioned("bhlm,bhld->bhmd", ds, qs, 2, 2)
    dv = partitioned("bhlm,bhld->bhmd", p, do, 2, 2)
    return dq, dk, dv


def _padded_dh(arrays, bias, l):
    """flash_attention's padding before `_run_fwd` / `_run_bwd`: L to a
    multiple of 256 (one block of 256) with -1e30 keys and zero rows, Dh to
    a multiple of 128 lanes."""
    lp = l + (-l) % 256
    pad = [np.pad(x, [(0, 0), (0, 0), (0, lp - l),
                      (0, -x.shape[-1] % 128)]) for x in arrays]
    return pad, np.pad(bias, [(0, 0), (0, lp - l)],
                       constant_values=-1e30), lp


@functools.lru_cache(maxsize=None)
def _card_case(dh):
    """The inputs of `_card_inputs(dh)` (dO of the all-masked element
    zeroed, as flash_attention's backward does), padded, and `_run_fwd`'s
    out and lse on them in interpret mode (one 256-row block): shared by
    the K2 and K3 cases of one width."""
    q, k, v, do, bias = _card_inputs(dh, seed=dh)
    do[2] = 0.0
    (qp, kp, vp, dop), bp, lp = _padded_dh((q, k, v, do), bias, 129)
    j = [jnp.asarray(x) for x in (qp, kp, vp, bp)]
    jout, jlse = jfa._run_fwd(*j, dh ** -0.5, lp, lp, True)
    return (q, k, v, do, bias), (j, jnp.asarray(dop), lp), (jout, jlse)


def _card_inputs(dh, seed):
    """(3, 1, 129, dh): tiles of 32 and 64 crossed, element 0 with a masked
    tail, element 1 with masked keys inside the valid range, element 2
    with every key masked."""
    b, h, l = 3, 1, 129
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((b, h, l, dh)).astype(np.float32)
                   for _ in range(4))
    bias = np.zeros((b, l), np.float32)
    bias[0, 100:] = -1e30
    bias[1, 5:90:3] = -1e30
    bias[2] = -1e30
    return q, k, v, do, bias


def test_k2_sums_each_output_over_its_keys_in_order():
    """The register-blocked P V (4-key groups a float4 load, 4 rows x 4 CG
    columns a lane) visits a tile's 32 keys in the order the shuffled loop
    did for every output, keys in order: the same FFMA chain, so its
    rounding, and the signed error it reads, are unchanged."""
    assert _k2_pv_order_card() == _k2_pv_order_shuffled() == list(range(32))


@pytest.mark.parametrize("dh", [32, 192])
def test_k2_card_order_meets_the_limits_against_jax(dh):
    """K2 step by step as the card runs it (k2_card) against `_run_fwd` in
    interpret mode and against float64, at (3, 1, 129, Dh) with a masked
    tail, masked keys inside the range and an all-masked element (its
    output, the mean of its keys' v, against that mean alone): out
    within 1e-4 of the largest value, lse within 1e-4 of max(1, |lse|),
    chip_smoke.py's limits for the kernel."""
    (q, k, v, _, bias), _, (jout, jlse) = _card_case(dh)
    t = [torch.from_numpy(x) for x in (q, k, v, bias)]
    out, lse = k2_card(*t)
    # the all-masked element averages v over the keys given, and the
    # padded keys change that average: it is held to float64 only
    _close(out[:2], np.asarray(jout)[:2, :, :129, :dh], "out")
    _close(lse, np.asarray(jlse)[:, :, :129], "lse", floor=1.0)
    out64, lse64 = fwd(*(x.double() for x in t), mm_exact)
    _close(out[:2], out64[:2].numpy(), "out f64")
    _close(lse[:2], lse64[:2].numpy(), "lse f64", floor=1.0)
    # every score of the all-masked element is -1e30 in f32: p = 1 for
    # each key (float64's -1e30 clamp would give 0 instead)
    _close(out[2], t[2][2].double().mean(1, keepdim=True).expand(
        out[2].shape).numpy(), "all-masked out")
    assert bool((lse[2] == torch.tensor(-1e30)).all())


@pytest.mark.parametrize("dh", [32, 192])
def test_k3_card_partition_meets_the_limits_against_jax(dh):
    """K3 step by step as the card runs it (k3_card: the wide instance's
    single running sums at Dh 192, the narrow instance's two halves at Dh
    32) against `_run_bwd` in interpret mode and against float64 on the
    same out and lse: dq, dk, dv within 1e-4 of the largest value."""
    (q, k, v, do, bias), (j, jdo, lp), (jout, jlse) = _card_case(dh)
    jgrads = jfa._run_bwd(*j, jout, jlse, jdo, dh ** -0.5, lp, lp, True)
    t = [torch.from_numpy(x) for x in (q, k, v, bias)]
    out = torch.from_numpy(np.asarray(jout)[:, :, :129, :dh].copy())
    lse = torch.from_numpy(np.asarray(jlse)[:, :, :129].copy())
    grads = k3_card(*t, out, lse, torch.from_numpy(do))
    exact = bwd(*(x.double() for x in t), out.double(), lse.double(),
                torch.from_numpy(do).double(), mm_exact)
    for name, g, r, x in zip(("dq", "dk", "dv"), grads, jgrads, exact):
        _close(g, np.asarray(r)[:, :, :129, :dh], name)
        _close(g, x.numpy(), name + " f64")
