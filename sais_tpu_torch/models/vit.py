"""DINO Vision Transformer (ViT-S/16, and the zoo's ViT-S/8, ViT-B/16 and
ViT-B/8) in PyTorch.

Counterpart of `sais_tpu/models/vit.py`.  The modules carry the names of
DINO's state_dict (dino-main/vision_transformer.py: `patch_embed.proj`,
`blocks.{i}.norm1`, `attn.qkv`, `attn.proj`, `mlp.fc1`, ...), so the
reference checkpoint `dino_deitsmall16_pretrain.pth` loads with
`load_state_dict` as it is.

Two inference paths, picked by the parameters' dtype:

- float32: the parity path of the JAX package (exact GELU, f32 scores,
  LayerNorm in f32 rounded to the activations' dtype);
- bfloat16: the fused path, every block one call of K1
  (`kernels.fused_mha.fused_vit_block`): the CUDA kernel on the card, its
  plain PyTorch version on the CPU.  It follows the JAX package's fused
  path on a TPU, including the tanh GELU of the Pallas kernel (JAX off a
  TPU runs bf16 through XLA with exact GELU instead).  With quant="int8"
  every block is one call of K8 (`fused_vit_block_int8`, W8A8 products,
  the weights quantized at every call), the opt-in throughput mode.

Two training paths (DINO pre-training), both bf16 over float32 master
parameters, with stochastic depth:

- `vit_features_trainable_fused`: every block one `TrainableFusedBlock`
  (K4 forward, K5 and K6 backward), drop path as per-row branch scales;
- `vit_forward_train`: plain PyTorch autograd with exact GELU (the JAX
  package's `vit_forward` at compute dtype bf16).

The patch embedding is the JAX formulation: patches in (kh, kw, c) order
times the reshaped conv kernel, a plain matmul.
"""

from __future__ import annotations

import math
import warnings
from typing import List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from sais_tpu_torch.config import ViTConfig
from sais_tpu_torch.kernels.fused_mha import (fused_vit_block,
                                              fused_vit_block_int8,
                                              layer_norm_f32,
                                              trainable_fused_block)


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


def prepare_tokens(model: VisionTransformer, images: torch.Tensor,
                   param_dtype=None) -> torch.Tensor:
    """Patch embedding + CLS token + positional embedding
    (vision_transformer.py:196-207).  images: (B, H, W, C) normalized.
    param_dtype: round the positional table to it before interpolating, as
    the JAX package's fused paths do (they cast every parameter first)."""
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
    pos = model.pos_embed if param_dtype is None else model.pos_embed.to(
        param_dtype)
    pe = interpolate_pos_embed(pos, gh * gw, gh, gw)
    return x + pe.to(x.dtype)


def _attention(x, attn: Attention, num_heads: int,
               return_weights: bool = False):
    """Pre-norm ViT attention, float32 scores (vision_transformer.py:80-92);
    with return_weights, (output, the softmax weights (B, heads, N, N))."""
    b, n, d = x.shape
    dh = d // num_heads
    qkv = attn.qkv(x)
    q, k, v = qkv.reshape(b, n, 3, num_heads, dh).unbind(2)
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * dh ** -0.5
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhnm,bmhd->bnhd", weights.to(x.dtype), v)
    out = attn.proj(out.reshape(b, n, d))
    return (out, weights) if return_weights else out


def _mlp(x, mlp: Mlp):
    """Transformer MLP with exact (erf) GELU, as torch nn.GELU."""
    return mlp.fc2(F.gelu(mlp.fc1(x).float()).to(x.dtype))


def block(x: torch.Tensor, blk: Block, num_heads: int, eps: float,
          return_weights: bool = False):
    """Pre-norm transformer block (vision_transformer.py:95-113); with
    return_weights, (output, its attention's softmax weights)."""
    y = _attention(_layer_norm(x, blk.norm1.weight, blk.norm1.bias, eps),
                   blk.attn, num_heads, return_weights)
    y, w = y if return_weights else (y, None)
    x = x + y
    x = x + _mlp(_layer_norm(x, blk.norm2.weight, blk.norm2.bias, eps),
                 blk.mlp)
    return (x, w) if return_weights else x


def vit_forward(model: VisionTransformer, images: torch.Tensor, *,
                return_last_attention: bool = False):
    """float32 path (JAX `vit_forward` off the fused path): CLS features
    (B, D); with return_last_attention, (features, the last block's
    softmax weights (B, heads, N + 1, N + 1)), get_last_selfattention
    (vision_transformer.py:216-223)."""
    cfg = model.cfg
    eps = cfg.layernorm_eps
    x = prepare_tokens(model, images.to(model.cls_token.dtype))
    last = len(model.blocks) - 1
    weights = None
    for i, blk in enumerate(model.blocks):
        if return_last_attention and i == last:
            x, weights = block(x, blk, cfg.num_heads, eps, True)
        else:
            x = block(x, blk, cfg.num_heads, eps)
    x = _layer_norm(x, model.norm.weight, model.norm.bias, eps)
    cls = x[:, 0].float()
    return (cls, weights) if return_last_attention else cls


def vit_intermediate_layers(model: VisionTransformer, images: torch.Tensor,
                            n: int = 1) -> List[torch.Tensor]:
    """Token sequences of the n last blocks, each through the final
    LayerNorm, earliest first: n float32 (B, 1 + N, D) tensors,
    get_intermediate_layers(x, n) (vision_transformer.py:224-232), the
    linear probe's feature source (eval_linear.py:166-170)."""
    cfg = model.cfg
    eps = cfg.layernorm_eps
    x = prepare_tokens(model, images.to(model.cls_token.dtype))
    depth = len(model.blocks)
    out = []
    for i, blk in enumerate(model.blocks):
        x = block(x, blk, cfg.num_heads, eps)
        if depth - i <= n:
            out.append(_layer_norm(x, model.norm.weight, model.norm.bias,
                                   eps).float())
    return out


def vit_tokens(model: VisionTransformer, images: torch.Tensor
               ) -> torch.Tensor:
    """The normalized token sequence (B, 1 + N, D) of the last block,
    get_intermediate_layers(x, n=1)[0] (vision_transformer.py:225-233):
    what the copy-detection, retrieval and video-segmentation evaluations
    read."""
    return vit_intermediate_layers(model, images, n=1)[-1]


def block_weights_bf16(blk: Block) -> list:
    """A block's 12 parameters as the kernels take them: bf16, linear
    weights (in, out), a zero qkv bias where the model has none.  The casts
    are differentiable, so gradients reach the float32 parameters."""

    def bf16(t, transpose=False):
        t = t.to(torch.bfloat16)
        return t.t().contiguous() if transpose else t

    attn, mlp = blk.attn, blk.mlp
    qkv_b = (bf16(attn.qkv.bias) if attn.qkv.bias is not None
             else attn.qkv.weight.new_zeros(attn.qkv.weight.shape[0],
                                            dtype=torch.bfloat16))
    return [bf16(attn.qkv.weight, True), qkv_b, bf16(attn.proj.weight, True),
            bf16(attn.proj.bias), bf16(mlp.fc1.weight, True),
            bf16(mlp.fc1.bias), bf16(mlp.fc2.weight, True),
            bf16(mlp.fc2.bias), bf16(blk.norm1.weight), bf16(blk.norm1.bias),
            bf16(blk.norm2.weight), bf16(blk.norm2.bias)]


def _cls_norm_bf16(model: VisionTransformer, x: torch.Tensor) -> torch.Tensor:
    """Final LayerNorm of the CLS row in bf16, returned float32.  LayerNorm
    is per row, so normalizing the CLS row alone gives what the JAX path
    takes from its LayerNorm over the first l rows."""
    cls = _layer_norm(x[:, 0], model.norm.weight.to(torch.bfloat16),
                      model.norm.bias.to(torch.bfloat16),
                      model.cfg.layernorm_eps)
    return cls.float()


def vit_forward_fused(model: VisionTransformer, images: torch.Tensor,
                      quant: Optional[str] = None) -> torch.Tensor:
    """bf16 fused path (JAX `_vit_forward_fused`): each block is one call
    on (B, L, D) of K1 (`fused_vit_block`), or of K8
    (`fused_vit_block_int8`) with quant="int8"."""
    if quant not in (None, "int8"):
        raise ValueError(f"quant={quant!r}: only None and 'int8' exist")
    block = fused_vit_block_int8 if quant == "int8" else fused_vit_block
    cfg = model.cfg
    x = prepare_tokens(model, images.to(torch.bfloat16),
                       torch.bfloat16).contiguous()
    l = x.shape[1]
    for blk in model.blocks:
        x = block(x, *block_weights_bf16(blk), num_heads=cfg.num_heads,
                  valid_len=l, eps=cfg.layernorm_eps)
    return _cls_norm_bf16(model, x)


def drop_path_scales(generator: torch.Generator, keep: float, b: int
                     ) -> torch.Tensor:
    """Per-image survivor scales in {0, 1/keep}: floor(keep + U[0, 1)) /
    keep (vision_transformer.py:27-35), drawn in float32 on the
    generator's device; callers cast the result to the compute dtype (a
    bf16 draw would quantize the drop probability to multiples of
    1/128)."""
    u = torch.rand((b,), generator=generator, dtype=torch.float32,
                   device=generator.device)
    return torch.floor(keep + u) / keep


def _drop_path_draws(generator, rate: float, depth: int, b: int):
    """Two independent draws a block (attention and MLP branch) at the
    linspace(0, rate, depth) probabilities (vision_transformer.py:150)."""
    out = []
    for i in range(depth):
        keep = 1.0 - rate * i / max(depth - 1, 1)
        out.append((drop_path_scales(generator, keep, b),
                    drop_path_scales(generator, keep, b)))
    return out


def vit_features_trainable_fused(model: VisionTransformer,
                                 images: torch.Tensor,
                                 drop_path_rate: float = 0.0,
                                 generator: torch.Generator = None,
                                 scales=None) -> torch.Tensor:
    """Differentiable fused path for DINO training (JAX
    `vit_features_trainable_fused`, backward='pallas'): bf16 copies of the
    parameters, every block one `TrainableFusedBlock` (K4 forward, K5 and
    K6 backward), CLS features (B, D) float32.

    Stochastic depth stays on the fused path: with drop_path_rate > 0 and a
    generator, each block draws two per-image scales in {0, 1/keep}, which
    become the kernels' (B, L, 1) branch scales.  `scales` injects the
    draws instead: a list, one (s1, s2) pair of (B,) tensors a block."""
    cfg = model.cfg
    x = prepare_tokens(model, images.to(torch.bfloat16),
                       torch.bfloat16).contiguous()
    b, l, _ = x.shape
    if scales is None and drop_path_rate > 0.0 and generator is not None:
        scales = _drop_path_draws(generator, drop_path_rate,
                                  len(model.blocks), b)
    for i, blk in enumerate(model.blocks):
        s1 = s2 = None
        if scales is not None:
            s1, s2 = (s.to(x.device, torch.bfloat16).reshape(b, 1, 1)
                      .expand(b, l, 1).contiguous() for s in scales[i])
        x = trainable_fused_block(x, block_weights_bf16(blk), cfg.num_heads,
                                  l, cfg.layernorm_eps, s1=s1, s2=s2)
    return _cls_norm_bf16(model, x)


def _linear_bf16(x, lin: nn.Linear):
    """x @ W in x's dtype, then the bias added in that dtype (the JAX
    package's `_linear`: the product is rounded before the bias)."""
    y = torch.matmul(x, lin.weight.to(x.dtype).t())
    return y if lin.bias is None else y + lin.bias.to(x.dtype)


def vit_forward_train(model: VisionTransformer, images: torch.Tensor,
                      drop_path_rate: float = 0.0,
                      generator: torch.Generator = None) -> torch.Tensor:
    """Plain bf16 training path (JAX `vit_forward` at compute dtype bf16,
    the one DINOTrainer takes without fused blocks): float32 parameters
    cast at each use, bf16 products and attention scores, f32 LayerNorm and
    softmax, exact GELU, stochastic depth as a per-image mask on each
    branch.  CLS features (B, D) float32, differentiable by autograd."""
    cfg = model.cfg
    eps, heads = cfg.layernorm_eps, cfg.num_heads
    x = prepare_tokens(model, images.to(torch.bfloat16))
    b, n, d = x.shape
    dh = d // heads
    draws = (_drop_path_draws(generator, drop_path_rate, len(model.blocks), b)
             if drop_path_rate > 0.0 and generator is not None else None)

    def branch(y, i, j):
        if draws is None:
            return y
        return y * draws[i][j].to(y.dtype).reshape(b, 1, 1)

    for i, blk in enumerate(model.blocks):
        y = _layer_norm(x, blk.norm1.weight, blk.norm1.bias, eps)
        q, k, v = _linear_bf16(y, blk.attn.qkv).reshape(
            b, n, 3, heads, dh).unbind(2)
        logits = torch.einsum("bnhd,bmhd->bhnm", q, k) * dh ** -0.5
        w = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        y = torch.einsum("bhnm,bmhd->bnhd", w, v).reshape(b, n, d)
        x = x + branch(_linear_bf16(y, blk.attn.proj), i, 0)
        y = _layer_norm(x, blk.norm2.weight, blk.norm2.bias, eps)
        y = F.gelu(_linear_bf16(y, blk.mlp.fc1).float()).to(x.dtype)
        x = x + branch(_linear_bf16(y, blk.mlp.fc2), i, 1)
    x = _layer_norm(x, model.norm.weight, model.norm.bias, eps)
    return x[:, 0].float()


def vit_features(model: VisionTransformer, images: torch.Tensor,
                 quant: Optional[str] = None) -> torch.Tensor:
    """CLS features (B, D) float32 of normalized images (B, H, W, C): the
    fused path when the model is bf16 (W8A8 blocks with quant="int8"), the
    float32 path otherwise, where quant is ignored with a warning (W8A8
    exists only in the fused blocks, JAX vit.py:393-400)."""
    if model.cls_token.dtype == torch.bfloat16:
        return vit_forward_fused(model, images, quant=quant)
    if quant is not None:
        warnings.warn(
            f"quant={quant!r} ignored: the fused path is not taken (it "
            "needs a bf16 model)", stacklevel=2)
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
