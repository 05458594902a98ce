"""DINO's VisionTransformer forward (vision_transformer.py), float32:
patch embedding as a strided convolution, CLS token, positional
embedding interpolated bicubically for other grids
(`interpolate_pos_encoding`), pre-norm blocks with exact GELU and
stochastic depth as per-image branch scales, the final LayerNorm, the CLS
row.  Weights are a dict under DINO's state_dict names."""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.precision import Round, conv, linear, mm

Weights = Dict[str, torch.Tensor]


def interpolate_pos_encoding(pos_embed: torch.Tensor, h: int, w: int,
                             patch: int) -> torch.Tensor:
    n = pos_embed.shape[1] - 1
    gh, gw = h // patch, w // patch
    if gh * gw == n and h == w:
        return pos_embed
    dim = pos_embed.shape[-1]
    side = int(math.sqrt(n))
    h0, w0 = gh + 0.1, gw + 0.1
    grid = F.interpolate(
        pos_embed[:, 1:].reshape(1, side, side, dim).permute(0, 3, 1, 2),
        scale_factor=(h0 / side, w0 / side), mode="bicubic")
    grid = grid.permute(0, 2, 3, 1).reshape(1, -1, dim)
    return torch.cat([pos_embed[:, :1], grid], dim=1)


def block(w: Weights, i: int, x: torch.Tensor, heads: int, eps: float,
          scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
          rnd: Round = None) -> torch.Tensor:
    p = f"blocks.{i}."
    b, n, d = x.shape
    dh = d // heads
    y = F.layer_norm(x, (d,), w[p + "norm1.weight"], w[p + "norm1.bias"],
                     eps)
    qkv = linear(y, w[p + "attn.qkv.weight"], w[p + "attn.qkv.bias"], rnd)
    q, k, v = qkv.reshape(b, n, 3, heads, dh).permute(2, 0, 3, 1, 4)
    attn = torch.softmax(mm(q, k.transpose(-2, -1), rnd) * dh ** -0.5, -1)
    y = mm(attn, v, rnd).transpose(1, 2).reshape(b, n, d)
    y = linear(y, w[p + "attn.proj.weight"], w[p + "attn.proj.bias"], rnd)
    if scales is not None:
        y = y * scales[0].reshape(b, 1, 1)
    x = x + y
    y = F.layer_norm(x, (d,), w[p + "norm2.weight"], w[p + "norm2.bias"],
                     eps)
    y = F.gelu(linear(y, w[p + "mlp.fc1.weight"], w[p + "mlp.fc1.bias"],
                      rnd))
    y = linear(y, w[p + "mlp.fc2.weight"], w[p + "mlp.fc2.bias"], rnd)
    if scales is not None:
        y = y * scales[1].reshape(b, 1, 1)
    return x + y


def features(w: Weights, images: torch.Tensor, cfg: dict,
             scales: Optional[Sequence] = None,
             rnd: Round = None) -> torch.Tensor:
    """images (B, H, W, 3) normalized float32 -> CLS features (B, D).
    scales: one (attention, MLP) pair of (B,) branch scales a block."""
    patch, heads, eps = cfg["patch_size"], cfg["num_heads"], \
        cfg["layernorm_eps"]
    x = images.permute(0, 3, 1, 2)
    b, _, h, wd = x.shape
    x = conv(x, w["patch_embed.proj.weight"], w["patch_embed.proj.bias"],
             patch, rnd)
    x = x.flatten(2).transpose(1, 2)
    x = torch.cat([w["cls_token"].expand(b, -1, -1), x], dim=1)
    x = x + interpolate_pos_encoding(w["pos_embed"], h, wd, patch)
    for i in range(cfg["depth"]):
        x = block(w, i, x, heads, eps,
                  None if scales is None else scales[i], rnd)
    x = F.layer_norm(x, (x.shape[-1],), w["norm.weight"], w["norm.bias"],
                     eps)
    return x[:, 0]


def normalize_uint8(frames: torch.Tensor, mean, std) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (x / 255 - mean) / std, float32."""
    x = frames.float() / 255.0
    return (x - torch.tensor(mean, device=x.device)) / torch.tensor(
        std, device=x.device)
