"""The port's CUDA kernels on the card, against their plain PyTorch
versions.  Every test here needs a CUDA device and skips without one.

This file imports neither jax nor the JAX package, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest
import torch

from sais_tpu_torch.config import ViTConfig
from sais_tpu_torch.kernels.fused_mha import (fused_vit_block,
                                              vit_block_reference)
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
                                       (5, 1, 1)])
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
    long_x, long_ws = _inputs(1, 1, 257)
    with pytest.raises(NotImplementedError, match="sequence length"):
        fused_vit_block(long_x, *long_ws, num_heads=6, valid_len=257)


def test_vit_fused_path_on_kernel_matches_plain(cuda):
    """A full-width ViT-S/16 (depth cut to 4) through K1 and through its
    plain version: CLS features within 5e-2 of the largest value."""
    cfg = ViTConfig(depth=4)
    model = vit_init(torch.Generator().manual_seed(0), cfg).to(
        cuda, torch.bfloat16)
    images = torch.randn((16, 224, 224, 3),
                         generator=torch.Generator().manual_seed(1)).to(cuda)
    before = fused_vit_block.launches
    with torch.inference_mode():
        got = vit_forward_fused(model, images)
        ref = vit_forward_fused(model, images, block=vit_block_reference)
    assert fused_vit_block.launches == before + cfg.depth
    assert got.shape == (16, 384) and torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= 5e-2 * ref.abs().max().item()
