"""Temporal transformer encoder over per-frame features.

Counterpart of `sais_tpu/models/temporal.py` (dense path).  The reference
builds 4-layer / 4-head torch TransformerEncoders (prepare_model.py:74-81),
patched so the encoder also returns the LAST layer's head-averaged
attention weights (README.md:43-48).  Semantics kept exactly:

- post-norm residual blocks: x = norm1(x + attn(x)); x = norm2(x + ffn(x));
- ReLU feed-forward of width 2048, LayerNorm eps 1e-5;
- q scaled by head_dim ** -0.5 before the score product;
- key_padding_mask True entries set to -1e30 (not -inf) before the
  float32 softmax.

Batch-major layout (torch's own encoder is sequence-major).  The modules
keep torch's TransformerEncoderLayer names (`self_attn.in_proj_weight`,
`linear1`, `norm1`, ...), so the reference's encoder weights map one to
one.

`use_flash` runs every layer's attention through K2 forward and K3
backward (`kernels.flash_attention.PackedFlashAttention`: the CUDA kernels
on the card, their plain versions on the CPU); the in_proj and out_proj
products stay outside the kernels as `F.linear`, as in JAX.  The (L, L)
weights are then never formed, the path is differentiable, and the
encoder returns the last layer's head-averaged CLS-query row (B, L),
computed without gradient (training reads only the video representation),
instead of the full matrix.  `full_model.resolve_flash` decides.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from sais_tpu_torch.config import TemporalConfig
from sais_tpu_torch.kernels.flash_attention import (cls_attention_row,
                                                    flash_attention_packed,
                                                    split_heads)
from sais_tpu_torch.models.vit import _layer_norm

_NEG_INF = -1e30


class MultiheadAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj = nn.Linear(d, d)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: TemporalConfig):
        super().__init__()
        d, f = cfg.rep_dim, cfg.ffn_dim
        self.self_attn = MultiheadAttention(d)
        self.linear1 = nn.Linear(d, f)
        self.linear2 = nn.Linear(f, d)
        self.norm1 = nn.LayerNorm(d, eps=cfg.layernorm_eps)
        self.norm2 = nn.LayerNorm(d, eps=cfg.layernorm_eps)


class TransformerEncoder(nn.Module):
    def __init__(self, cfg: TemporalConfig):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(cfg)
                                    for _ in range(cfg.num_layers))


def multihead_attention(x: torch.Tensor, mha: MultiheadAttention,
                        num_heads: int,
                        key_padding_mask: Optional[torch.Tensor]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """nn.MultiheadAttention eval semantics.  x: (B, L, D);
    key_padding_mask: (B, L) bool, True = pad.  Returns (out (B, L, D),
    head-averaged weights (B, L, L))."""
    b, l, d = x.shape
    dh = d // num_heads
    qkv = F.linear(x, mha.in_proj_weight, mha.in_proj_bias)
    q, k, v = (t.reshape(b, l, num_heads, dh).transpose(1, 2)
               for t in qkv.split(d, dim=-1))
    logits = torch.einsum("bhld,bhmd->bhlm", (q * dh ** -0.5).float(),
                          k.float())
    if key_padding_mask is not None:
        logits = torch.where(key_padding_mask[:, None, None, :], _NEG_INF,
                             logits)
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhlm,bhmd->bhld", weights.to(x.dtype), v)
    out = mha.out_proj(out.transpose(1, 2).reshape(b, l, d))
    return out, weights.mean(dim=1)


def multihead_attention_flash(x: torch.Tensor, mha: MultiheadAttention,
                              num_heads: int,
                              key_padding_mask: Optional[torch.Tensor],
                              want_cls_row: bool = False
                              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """`multihead_attention` through K2 / K3, without the (L, L) weights.
    q, k and v go to the kernels as (B, H, L, Dh) views of the projection,
    the output comes back as a view of a (B, L, H, Dh) buffer and the
    backward writes the projection's gradient into one (B, L, 3 D) buffer,
    so no operand is copied.  Returns (out, CLS-row attention (B, L) when
    asked, else None); the row is a reported quantity, computed without
    gradient."""
    b, l, d = x.shape
    qkv = F.linear(x, mha.in_proj_weight, mha.in_proj_bias)
    out = flash_attention_packed(qkv, num_heads, key_padding_mask)
    out = mha.out_proj(out.transpose(1, 2).reshape(b, l, d))
    cls_row = None
    if want_cls_row:
        with torch.no_grad():
            q, k, _ = split_heads(qkv, num_heads)
            cls_row = cls_attention_row(q, k, key_padding_mask)
    return out, cls_row


def encoder_layer(x: torch.Tensor, layer: EncoderLayer, cfg: TemporalConfig,
                  key_padding_mask: Optional[torch.Tensor],
                  use_flash: bool = False, want_cls_row: bool = False
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Post-norm torch TransformerEncoderLayer (activation=relu)."""
    if use_flash:
        y, attn = multihead_attention_flash(x, layer.self_attn,
                                            cfg.num_heads, key_padding_mask,
                                            want_cls_row)
    else:
        y, attn = multihead_attention(x, layer.self_attn, cfg.num_heads,
                                      key_padding_mask)
    eps = cfg.layernorm_eps
    x = _layer_norm(x + y, layer.norm1.weight, layer.norm1.bias, eps)
    h = layer.linear2(torch.relu(layer.linear1(x)))
    x = _layer_norm(x + h, layer.norm2.weight, layer.norm2.bias, eps)
    return x, attn


def encoder_forward(encoder: TransformerEncoder, x: torch.Tensor,
                    cfg: TemporalConfig,
                    key_padding_mask: Optional[torch.Tensor] = None,
                    use_flash: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stacked encoder -> (output, last layer's head-averaged attention):
    (B, L, L) dense, or the CLS-query row (B, L) with use_flash."""
    attn = None
    n = len(encoder.layers)
    for i, layer in enumerate(encoder.layers):
        x, attn = encoder_layer(x, layer, cfg, key_padding_mask, use_flash,
                                want_cls_row=use_flash and i == n - 1)
    return x, attn


def encoder_init(encoder: TransformerEncoder, generator: torch.Generator,
                 cfg: TemporalConfig) -> None:
    """In place, as the JAX `encoder_init`: xavier-uniform in_proj, torch
    Linear-style uniform feed-forward and out_proj weights, zero biases,
    unit LayerNorm."""
    d, f = cfg.rep_dim, cfg.ffn_dim

    def uniform_(t, lim):
        with torch.no_grad():
            t.copy_((torch.rand(t.shape, generator=generator) * 2 - 1) * lim)

    for layer in encoder.layers:
        uniform_(layer.self_attn.in_proj_weight, (6.0 / (d + 3 * d)) ** 0.5)
        uniform_(layer.self_attn.out_proj.weight, (1 / d) ** 0.5)
        uniform_(layer.linear1.weight, (1 / d) ** 0.5)
        uniform_(layer.linear2.weight, (1 / f) ** 0.5)
        for p in (layer.self_attn.in_proj_bias, layer.self_attn.out_proj.bias,
                  layer.linear1.bias, layer.linear2.bias, layer.norm1.bias,
                  layer.norm2.bias):
            nn.init.zeros_(p)
        nn.init.ones_(layer.norm1.weight)
        nn.init.ones_(layer.norm2.weight)
