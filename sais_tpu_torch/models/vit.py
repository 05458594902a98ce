"""DINO Vision Transformer (ViT-S/16) in PyTorch.

Counterpart of `sais_tpu/models/vit.py`.  The modules carry the names of
DINO's state_dict (dino-main/vision_transformer.py: `patch_embed.proj`,
`blocks.{i}.norm1`, `attn.qkv`, `attn.proj`, `mlp.fc1`, ...), so the
reference checkpoint `dino_deitsmall16_pretrain.pth` loads with
`load_state_dict` as it is.

Two forward paths, picked by the parameters' dtype:

- float32: the parity path of the JAX package (exact GELU, f32 scores,
  LayerNorm in f32 rounded to the activations' dtype);
- bfloat16: the fused path, every block one call of K1
  (`kernels.fused_mha.fused_vit_block`): the CUDA kernel on the card, its
  plain PyTorch version on the CPU.  It follows the JAX package's fused
  path on a TPU, including the tanh GELU of the Pallas kernel (JAX off a
  TPU runs bf16 through XLA with exact GELU instead).

The patch embedding is the JAX formulation: patches in (kh, kw, c) order
times the reshaped conv kernel, a plain matmul.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from sais_tpu_torch.config import ViTConfig
from sais_tpu_torch.kernels.fused_mha import fused_vit_block, layer_norm_f32


class PatchEmbed(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.proj = nn.Conv2d(cfg.in_channels, cfg.embed_dim,
                              kernel_size=cfg.patch_size,
                              stride=cfg.patch_size)


class Attention(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d = cfg.embed_dim
        self.qkv = nn.Linear(d, 3 * d, bias=cfg.qkv_bias)
        self.proj = nn.Linear(d, d)


class Mlp(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.embed_dim, cfg.mlp_dim)
        self.fc2 = nn.Linear(cfg.mlp_dim, cfg.embed_dim)


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d, eps = cfg.embed_dim, cfg.layernorm_eps
        self.norm1 = nn.LayerNorm(d, eps=eps)
        self.attn = Attention(cfg)
        self.norm2 = nn.LayerNorm(d, eps=eps)
        self.mlp = Mlp(cfg)


class VisionTransformer(nn.Module):
    """Parameter container; the forward is `vit_features`."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.num_patches + 1, d))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(d, eps=cfg.layernorm_eps)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return vit_features(self, images)


def _layer_norm(x, scale, bias, eps):
    """LayerNorm over the last axis in float32, cast back to x's dtype."""
    return layer_norm_f32(x, scale, bias, eps).to(x.dtype)


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/p * W/p, p*p*C) in (kh, kw, c) pixel order."""
    b, h, w, c = images.shape
    gh, gw = h // patch, w // patch
    x = images.reshape(b, gh, patch, gw, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch * patch * c)


def patch_embed_weight(model: VisionTransformer) -> torch.Tensor:
    """Conv kernel (D, C, kh, kw) -> (kh*kw*C, D) for `patchify` order."""
    w = model.patch_embed.proj.weight
    return w.permute(2, 3, 1, 0).reshape(-1, w.shape[0])


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Cubic convolution kernel with torch's bicubic a = -0.75."""
    ax = np.abs(x)
    return np.where(ax <= 1, (a + 2) * ax ** 3 - (a + 3) * ax ** 2 + 1,
                    np.where(ax < 2,
                             a * ax ** 3 - 5 * a * ax ** 2 + 8 * a * ax - 4 * a,
                             0.0))


def _torch_bicubic_matrix(in_size: int, out_size: int, scale: float
                          ) -> np.ndarray:
    """(out, in) matrix of F.interpolate(mode='bicubic',
    align_corners=False) with an explicit scale_factor: source coordinate
    (i + 0.5) / scale - 0.5 from the GIVEN scale, 4 taps, border-clamped."""
    m = np.zeros((out_size, in_size), np.float64)
    for i in range(out_size):
        src = (i + 0.5) / scale - 0.5
        i0 = int(np.floor(src))
        taps = np.arange(i0 - 1, i0 + 3)
        w = _cubic_kernel(taps - src)
        for tp, wt in zip(np.clip(taps, 0, in_size - 1), w):
            m[i, tp] += wt
    return m.astype(np.float32)


def interpolate_pos_embed(pos_embed: torch.Tensor, npatch: int, gh: int,
                          gw: int) -> torch.Tensor:
    """Bicubic pos-embedding interpolation for non-224 inputs
    (vision_transformer.py:174-194), with DINO's (g + 0.1) / sqrt(N) scale,
    as two (out, in) matrices applied in float32."""
    n = pos_embed.shape[1] - 1
    if npatch == n and gh == gw:
        return pos_embed
    dim = pos_embed.shape[-1]
    side = int(math.sqrt(n))
    grid = pos_embed[0, 1:].reshape(side, side, dim).float()
    dev = pos_embed.device
    mh = torch.from_numpy(_torch_bicubic_matrix(side, gh, (gh + 0.1) / side))
    mw = torch.from_numpy(_torch_bicubic_matrix(side, gw, (gw + 0.1) / side))
    out = torch.einsum("oh,hwd->owd", mh.to(dev), grid)
    out = torch.einsum("pw,hwd->hpd", mw.to(dev), out).to(pos_embed.dtype)
    return torch.cat([pos_embed[:, :1], out.reshape(1, gh * gw, dim)], dim=1)


def prepare_tokens(model: VisionTransformer, images: torch.Tensor
                   ) -> torch.Tensor:
    """Patch embedding + CLS token + positional embedding
    (vision_transformer.py:196-207).  images: (B, H, W, C) normalized."""
    cfg = model.cfg
    b, h, w, _ = images.shape
    # the product is rounded to the activations' dtype before the bias is
    # added, as the JAX package's bf16 path does
    x = torch.matmul(patchify(images, cfg.patch_size),
                     patch_embed_weight(model).to(images.dtype))
    x = x + model.patch_embed.proj.bias.to(x.dtype)
    cls = model.cls_token.to(x.dtype).expand(b, 1, cfg.embed_dim)
    x = torch.cat([cls, x], dim=1)
    gh, gw = h // cfg.patch_size, w // cfg.patch_size
    pe = interpolate_pos_embed(model.pos_embed, gh * gw, gh, gw)
    return x + pe.to(x.dtype)


def _attention(x, attn: Attention, num_heads: int):
    """Pre-norm ViT attention, float32 scores (vision_transformer.py:80-92)."""
    b, n, d = x.shape
    dh = d // num_heads
    qkv = attn.qkv(x)
    q, k, v = qkv.reshape(b, n, 3, num_heads, dh).unbind(2)
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * dh ** -0.5
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhnm,bmhd->bnhd", weights.to(x.dtype), v)
    return attn.proj(out.reshape(b, n, d))


def _mlp(x, mlp: Mlp):
    """Transformer MLP with exact (erf) GELU, as torch nn.GELU."""
    return mlp.fc2(F.gelu(mlp.fc1(x).float()).to(x.dtype))


def vit_forward(model: VisionTransformer, images: torch.Tensor
                ) -> torch.Tensor:
    """float32 path (JAX `vit_forward` off the fused path): CLS features."""
    cfg = model.cfg
    eps = cfg.layernorm_eps
    x = prepare_tokens(model, images.to(model.cls_token.dtype))
    for blk in model.blocks:
        x = x + _attention(_layer_norm(x, blk.norm1.weight, blk.norm1.bias,
                                       eps), blk.attn, cfg.num_heads)
        x = x + _mlp(_layer_norm(x, blk.norm2.weight, blk.norm2.bias, eps),
                     blk.mlp)
    x = _layer_norm(x, model.norm.weight, model.norm.bias, eps)
    return x[:, 0].float()


def vit_forward_fused(model: VisionTransformer, images: torch.Tensor,
                      block=fused_vit_block) -> torch.Tensor:
    """bf16 fused path (JAX `_vit_forward_fused`): each block is one K1
    call on (B, L, D).  `block` is K1's wrapper; `vit_block_reference`
    runs the same path through the plain version, to hold the kernel
    against it end to end."""
    cfg = model.cfg
    x = prepare_tokens(model, images.to(torch.bfloat16)).contiguous()
    b, l, d = x.shape

    def bf16(t, transpose=False):   # parameters in bf16, weights (in, out)
        t = t.to(torch.bfloat16)
        return t.t().contiguous() if transpose else t

    for blk in model.blocks:
        attn, mlp = blk.attn, blk.mlp
        qkv_b = (bf16(attn.qkv.bias) if attn.qkv.bias is not None
                 else x.new_zeros(3 * d))
        x = block(x, bf16(attn.qkv.weight, True), qkv_b,
                  bf16(attn.proj.weight, True), bf16(attn.proj.bias),
                  bf16(mlp.fc1.weight, True), bf16(mlp.fc1.bias),
                  bf16(mlp.fc2.weight, True), bf16(mlp.fc2.bias),
                  bf16(blk.norm1.weight), bf16(blk.norm1.bias),
                  bf16(blk.norm2.weight), bf16(blk.norm2.bias),
                  num_heads=cfg.num_heads, valid_len=l,
                  eps=cfg.layernorm_eps)
    # LayerNorm is per row, so normalizing the CLS row alone gives what the
    # JAX path takes from its LayerNorm over the first l rows.
    cls = _layer_norm(x[:, 0], bf16(model.norm.weight), bf16(model.norm.bias),
                      cfg.layernorm_eps)
    return cls.float()


def vit_features(model: VisionTransformer, images: torch.Tensor
                 ) -> torch.Tensor:
    """CLS features (B, D) float32 of normalized images (B, H, W, C): the
    fused path when the model is bf16, the float32 path otherwise."""
    if model.cls_token.dtype == torch.bfloat16:
        return vit_forward_fused(model, images)
    return vit_forward(model, images)


def vit_init(generator: torch.Generator, cfg: ViTConfig) -> VisionTransformer:
    """Random model on the CPU, as the reference initializes
    (vision_transformer.py:161-172): normal(0.02) weights and pos/cls
    embeddings truncated at +-2 (absolute, so in effect untruncated), zero
    biases, unit LayerNorm."""
    model = VisionTransformer(cfg)

    def trunc_normal_(t):
        with torch.no_grad():
            t.copy_((0.02 * torch.randn(t.shape, generator=generator))
                    .clamp_(-2.0, 2.0))

    for name, p in model.named_parameters():
        if name.endswith("bias"):
            nn.init.zeros_(p)
        elif ".norm" in name or name.startswith("norm."):
            nn.init.ones_(p)
        else:
            trunc_normal_(p)
    return model
