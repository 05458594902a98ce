"""K1 (sais_tpu_torch.kernels.fused_mha): the plain PyTorch version against
the JAX package's Pallas kernel `fused_vit_block`, run in interpret mode
on the CPU.  The CUDA kernel is held against the plain version on the card
in tests/test_torch_cuda.py."""

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


def _jax_gemm(a, w, bias, epilogue, residual=None, row_scale=None):
    """The Pallas bodies' epilogue arithmetic in jnp: the f32-accumulated
    product rounded to bf16, + bias in bf16, then tanh GELU in f32 or
    residual + [row_scale *] v in bf16."""
    import jax
    bf = jnp.bfloat16
    v = jnp.dot(jnp.asarray(a, bf), jnp.asarray(w, bf),
                preferred_element_type=jnp.float32).astype(bf)
    v = v + jnp.asarray(bias, bf)
    if epilogue == "gelu":
        return jax.nn.gelu(v.astype(jnp.float32), approximate=True).astype(bf)
    if epilogue == "residual":
        if row_scale is not None:
            v = v * jnp.asarray(row_scale, bf)[:, None]
        return jnp.asarray(residual, bf) + v
    return v


@pytest.mark.parametrize("epilogue,scaled", [("bias", False),
                                             ("gelu", False),
                                             ("residual", False),
                                             ("residual", True)])
def test_block_gemm_plain_version_matches_jax(epilogue, scaled):
    """The GEMM of K1's and K4's four products (`block_gemm`) on the CPU
    runs its plain version, uncounted, with the JAX bodies' rounding
    points; M = 37 is ragged.  Limit: 2 bf16 ulps of the largest output
    (the f32 products sum in another order)."""
    from sais_tpu_torch.kernels.fused_mha import block_gemm
    rng = np.random.default_rng(3)
    m, k, n = 37, 2 * D, 3 * D
    a = rng.standard_normal((m, k)).astype(np.float32)
    w = 0.05 * rng.standard_normal((k, n)).astype(np.float32)
    bias = 0.05 * rng.standard_normal(n).astype(np.float32)
    residual = row_scale = None
    if epilogue == "residual":
        residual = rng.standard_normal((m, n)).astype(np.float32)
    if scaled:
        row_scale = np.where(rng.random(m) < 0.75, 1 / 0.9, 0.0).astype(
            np.float32)
        row_scale[0] = 0.0
    bf = torch.bfloat16
    before = block_gemm.launches
    got = block_gemm(*(torch.tensor(t).to(bf) for t in (a, w, bias)),
                     epilogue,
                     None if residual is None else torch.tensor(residual).to(bf),
                     None if row_scale is None
                     else torch.tensor(row_scale).to(bf))
    assert block_gemm.launches == before
    assert got.shape == (m, n) and got.dtype == bf
    ref = np.asarray(_jax_gemm(a, w, bias, epilogue, residual, row_scale)
                     .astype(jnp.float32))
    top = float(np.abs(ref).max())
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                               atol=2 * ulp)


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
