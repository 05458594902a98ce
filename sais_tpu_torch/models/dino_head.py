"""DINO projection head (reference: dino-main/vision_transformer.py:257-291).

Counterpart of `sais_tpu/models/dino_head.py`: a 3-layer MLP (in -> 2048 ->
2048 -> bottleneck 256) with exact GELU, L2 row normalization, then a
weight-normalized linear to the prototype dimension (65536 by default)
whose per-prototype gain g is frozen at 1 when norm_last_layer=True (the
reference default for ViT-S).

Parameters keep the JAX package's names and the torch layout of the
backbone: `mlp` is three `nn.Linear` (weights (out, in)), `last_v` is
(bottleneck, out_dim), one column per prototype as in the JAX package,
`last_g` is (out_dim,).

The head is plain PyTorch (large products go to torch.matmul).  On the
fused-loss path (`DINOTrainer(fused_loss=True)`) the trainer calls
`dino_head_bottleneck` only, and the weight-normed last layer runs inside
K7 (`kernels.dino_head_loss`) with the loss.  The `use_bn_in_head` variant
is not ported (ROADMAP Queue 1).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from sais_tpu_torch.kernels.dino_head_loss import normed_w


class DINOHead(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, hidden: int = 2048,
                 bottleneck: int = 256):
        super().__init__()
        self.mlp = nn.ModuleList([nn.Linear(in_dim, hidden),
                                  nn.Linear(hidden, hidden),
                                  nn.Linear(hidden, bottleneck)])
        self.last_v = nn.Parameter(torch.zeros(bottleneck, out_dim))
        self.last_g = nn.Parameter(torch.ones(out_dim))


def _refuse_bn(use_bn: bool) -> None:
    if use_bn:
        raise NotImplementedError(
            "the use_bn_in_head DINO head (--use-bn-in-head) is not ported "
            "yet; it comes with its own slice (ROADMAP Queue 1)")


def dino_head_init(generator: torch.Generator, in_dim: int, out_dim: int,
                   hidden: int = 2048, bottleneck: int = 256,
                   use_bn: bool = False) -> DINOHead:
    """The reference init on the CPU: normal(0.02) weights truncated at the
    ABSOLUTE bounds +-2 (dino-main/utils.py trunc_normal_, in effect
    untruncated at std 0.02), zero biases, g = 1."""
    _refuse_bn(use_bn)
    head = DINOHead(in_dim, out_dim, hidden, bottleneck)

    def trunc_normal_(t):
        with torch.no_grad():
            t.copy_((0.02 * torch.randn(t.shape, generator=generator))
                    .clamp_(-2.0, 2.0))

    for lin in head.mlp:
        trunc_normal_(lin.weight)
        nn.init.zeros_(lin.bias)
    trunc_normal_(head.last_v)
    return head


def dino_head_bottleneck(head: DINOHead, x: torch.Tensor) -> torch.Tensor:
    """MLP + L2 row normalization (vision_transformer.py:283-287).  The
    products run at x's dtype with the parameters cast at use, GELU in
    float32; the normalization divides by a float32 norm, so the result is
    float32 (as the JAX package's type promotion makes it).  A collapsed
    row yields zeros, not NaNs (F.normalize's eps 1e-12)."""
    h = x
    for i, lin in enumerate(head.mlp):
        h = torch.matmul(h, lin.weight.to(h.dtype).t()) + lin.bias.to(h.dtype)
        if i < len(head.mlp) - 1:
            h = F.gelu(h.float()).to(x.dtype)
    norm = torch.linalg.vector_norm(h.float(), dim=-1, keepdim=True)
    return h / torch.clamp(norm, min=1e-12)


def dino_last_layer(h: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                    norm_last_layer: bool = True, bf16: bool = True
                    ) -> torch.Tensor:
    """The weight-normed last layer: h (rows, bottleneck) -> (rows,
    out_dim) logits float32, w = v / ||v||_col [* g] in float32 with K7's
    column norm (`kernels.dino_head_loss.normed_w`).  With `bf16` the
    product takes bf16 operands with float32 accumulation (bf16 values
    multiply exactly in float32), as under the reference's autocast."""
    w = normed_w(v, g, not norm_last_layer)[0]
    if bf16:
        return torch.matmul(h.to(torch.bfloat16).float(),
                            w.to(torch.bfloat16).float())
    return torch.matmul(h.float(), w)


def dino_head_forward(head: DINOHead, x: torch.Tensor,
                      norm_last_layer: bool = True) -> torch.Tensor:
    """x: (B, in_dim) -> (B, out_dim) prototype logits, float32.  With bf16
    input the whole head runs at that precision: bf16 MLP products, then
    `dino_last_layer` on bf16 operands."""
    return dino_last_layer(dino_head_bottleneck(head, x), head.last_v,
                           head.last_g, norm_last_layer,
                           x.dtype == torch.bfloat16)
