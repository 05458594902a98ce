"""K1 (sais_tpu_torch.kernels.fused_mha): the plain PyTorch version against
the JAX package's Pallas kernel `fused_vit_block`, run in interpret mode
on the CPU, and the plain version of the blocks' GEMM (`block_gemm`, every
product of K1, K4, K5 and K6) against jnp.  The CUDA kernels are held
against the plain versions on the card in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sais_tpu.kernels.fused_mha import fused_vit_block as jax_block
from sais_tpu_torch.kernels.fused_mha import (fused_vit_block,
                                              vit_block_reference)

HEADS, D, L, B = 2, 64, 24, 3


def _inputs(seed, b=B, l=L, d=D, mlp=4 * D):
    rng = np.random.default_rng(seed)
    shapes = [(d, 3 * d), (3 * d,), (d, d), (d,), (d, mlp), (mlp,),
              (mlp, d), (d,), (d,), (d,), (d,), (d,)]
    ws = [0.05 * rng.standard_normal(s).astype(np.float32) for s in shapes]
    ws[8] += 1.0    # LN scales near 1
    ws[10] += 1.0
    x = rng.standard_normal((b, l, d)).astype(np.float32)
    return x, ws


def _both(x, ws, valid, jdtype, tdtype):
    ref = jax_block(jnp.asarray(x, jdtype), *[jnp.asarray(w, jdtype)
                                              for w in ws],
                    num_heads=HEADS, valid_len=valid, interpret=True)
    got = fused_vit_block(torch.tensor(x).to(tdtype),
                          *[torch.tensor(w).to(tdtype) for w in ws],
                          num_heads=HEADS, valid_len=valid)
    return np.asarray(ref.astype(jnp.float32)), got.float().numpy()


@pytest.mark.parametrize("valid", [L, 17])
def test_plain_version_matches_pallas_f32(valid):
    """f32: the same function up to summation order (the JAX fused-backward
    tests hold the Pallas block to 1e-4 the same way)."""
    x, ws = _inputs(0)
    ref, got = _both(x, ws, valid, jnp.float32, torch.float32)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("valid", [L, 17])
def test_plain_version_matches_pallas_bf16(valid):
    """bf16: both round at the same points, so outputs of magnitude <= 4
    differ by at most 2 bf16 ulps there (ulp 2**-6 in [2, 4))."""
    x, ws = _inputs(1)
    ref, got = _both(x, ws, valid, jnp.bfloat16, torch.bfloat16)
    assert np.abs(ref).max() < 4.0
    np.testing.assert_allclose(got, ref, rtol=0, atol=2 * 2.0 ** -6)


def test_cpu_tensor_runs_plain_version_without_counting():
    x, ws = _inputs(2)
    before = fused_vit_block.launches
    tx, tw = torch.tensor(x), [torch.tensor(w) for w in ws]
    out = fused_vit_block(tx, *tw, num_heads=HEADS, valid_len=L)
    assert fused_vit_block.launches == before
    torch.testing.assert_close(
        out, vit_block_reference(tx, *tw, num_heads=HEADS, valid_len=L),
        rtol=0, atol=0)


def _jax_gemm(a, w, bias, epilogue, residual=None, row_scale=None,
              aux=None):
    """The Pallas bodies' product arithmetic in jnp.  Forward (K1, K4, and
    K5's fc1 recompute): the f32-accumulated product rounded to bf16, +
    bias in bf16, then tanh GELU in f32 or residual + [row_scale *] v in
    bf16.  Backward (K5, K6): a @ w^T rounded ("none"), times
    `_gelu_tanh_and_grad`'s derivative of aux in f32 then rounded
    ("dgelu"), in f32 ("f32"); a^T @ w in f32 ("wgrad")."""
    import jax
    from sais_tpu.kernels.fused_mha import _gelu_tanh_and_grad
    bf, f32 = jnp.bfloat16, jnp.float32
    a, w = jnp.asarray(a, bf), jnp.asarray(w, bf)
    if epilogue in ("none", "dgelu", "f32"):
        v = jnp.dot(a, w.T, preferred_element_type=f32)
        if epilogue == "dgelu":
            v = v * _gelu_tanh_and_grad(jnp.asarray(aux, bf).astype(f32))[1]
        return v if epilogue == "f32" else v.astype(bf)
    if epilogue == "wgrad":
        return jnp.dot(a.T, w, preferred_element_type=f32)
    v = jnp.dot(a, w, preferred_element_type=f32).astype(bf)
    v = v + jnp.asarray(bias, bf)
    if epilogue in ("gelu", "gelu_save"):
        g = jax.nn.gelu(v.astype(f32), approximate=True).astype(bf)
        return (v, g) if epilogue == "gelu_save" else g
    if epilogue == "residual":
        if row_scale is not None:
            v = v * jnp.asarray(row_scale, bf)[:, None]
        return jnp.asarray(residual, bf) + v
    return v


@pytest.mark.parametrize("epilogue,scaled", [("bias", False),
                                             ("gelu", False),
                                             ("residual", False),
                                             ("residual", True),
                                             ("none", False),
                                             ("gelu_save", False),
                                             ("dgelu", False),
                                             ("f32", False),
                                             ("wgrad", False)])
def test_block_gemm_plain_version_matches_jax(epilogue, scaled):
    """The blocks' GEMM (`block_gemm`: K1's and K4's four products, K5's
    and K6's ten) on the CPU runs its plain version, uncounted, with the
    JAX bodies' rounding points; M = 37 rows are ragged (for "wgrad" the
    37 rows are the reduction).  Limits: bf16 outputs 2 bf16 ulps of the
    largest output, f32 outputs 1e-5 of it (the f32 products sum in
    another order)."""
    from sais_tpu_torch.kernels.fused_mha import block_gemm
    rng = np.random.default_rng(3)
    m, k, n = 37, 2 * D, 3 * D
    a = rng.standard_normal((m, k)).astype(np.float32)
    w_shape = {"none": (n, k), "dgelu": (n, k), "f32": (n, k),
               "wgrad": (m, n)}.get(epilogue, (k, n))
    w = 0.05 * rng.standard_normal(w_shape).astype(np.float32)
    bias = None
    if epilogue in ("bias", "gelu", "residual", "gelu_save"):
        bias = 0.05 * rng.standard_normal(n).astype(np.float32)
    residual = row_scale = aux = None
    if epilogue == "residual":
        residual = rng.standard_normal((m, n)).astype(np.float32)
    if epilogue == "dgelu":
        aux = rng.standard_normal((m, n)).astype(np.float32)
    if scaled:
        row_scale = np.where(rng.random(m) < 0.75, 1 / 0.9, 0.0).astype(
            np.float32)
        row_scale[0] = 0.0
    bf = torch.bfloat16

    def t(x):
        return None if x is None else torch.tensor(x).to(bf)

    before = block_gemm.launches
    got = block_gemm(t(a), t(w), t(bias), epilogue, t(residual),
                     t(row_scale), t(aux))
    assert block_gemm.launches == before
    ref = _jax_gemm(a, w, bias, epilogue, residual, row_scale, aux)
    pairs = zip(got, ref) if epilogue == "gelu_save" else [(got, ref)]
    out_shape = (k, n) if epilogue == "wgrad" else (m, n)
    f32 = epilogue in ("f32", "wgrad")
    for g, r in pairs:
        r = np.asarray(r.astype(jnp.float32))
        assert g.shape == out_shape
        assert g.dtype == (torch.float32 if f32 else bf)
        top = float(np.abs(r).max())
        tol = 1e-5 * top if f32 else 2 * 2.0 ** (np.floor(np.log2(top)) - 7)
        np.testing.assert_allclose(g.float().numpy(), r, rtol=0, atol=tol)


def test_block_gemm_rejects_mismatched_epilogue_operands():
    from sais_tpu_torch.kernels.fused_mha import block_gemm
    a, w, b = torch.zeros((4, 64)), torch.zeros((64, 64)), torch.zeros(64)
    with pytest.raises(ValueError, match="epilogue"):
        block_gemm(a, w, b, "relu")
    with pytest.raises(ValueError, match="residual"):
        block_gemm(a, w, b, "residual")
    with pytest.raises(ValueError, match="residual"):
        block_gemm(a, w, b, "gelu", residual=torch.zeros((4, 64)))
    with pytest.raises(ValueError, match="residual"):
        block_gemm(a, w, b, "bias", row_scale=torch.ones(4))
    with pytest.raises(ValueError, match="aux"):
        block_gemm(a, w, None, "dgelu")
    with pytest.raises(ValueError, match="aux"):
        block_gemm(a, w, b, "gelu", aux=torch.zeros((4, 64)))
    with pytest.raises(ValueError, match="bias"):
        block_gemm(a, w, b, "f32")
    with pytest.raises(ValueError, match="bias"):
        block_gemm(a, w, None, "gelu_save")
