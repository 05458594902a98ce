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
K7 (`kernels.dino_head_loss`) with the loss.

The `--use_bn_in_head` variant (main_dino.py:70) puts a BatchNorm1d after
each hidden linear (the reference's Sequential indices 1 and 4,
vision_transformer.py:264-271).  Its scale and bias are parameters of the
head (`bn`, EMA'd into the teacher with the rest); its running statistics
are a state the caller threads through `dino_head_forward(...,
bn_state=..., train=True)` (`dino_head_bn_init`), as in the JAX package:
each network's statistics come from its own forwards and are never
averaged by the EMA (main_dino.py:563-567).  Such a head runs the plain
head and loss, never K7 (JAX refuses the fused loss with it).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from sais_tpu_torch.kernels.dino_head_loss import normed_w


_BN_EPS = 1e-5        # torch BatchNorm1d defaults
_BN_MOMENTUM = 0.1

BNState = List[Dict[str, torch.Tensor]]


class BatchNormAffine(nn.Module):
    """A BatchNorm1d's scale and bias (torch init 1 and 0); its running
    statistics live in the caller's `BNState`."""

    def __init__(self, width: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))


class DINOHead(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, hidden: int = 2048,
                 bottleneck: int = 256, use_bn: bool = False):
        super().__init__()
        self.mlp = nn.ModuleList([nn.Linear(in_dim, hidden),
                                  nn.Linear(hidden, hidden),
                                  nn.Linear(hidden, bottleneck)])
        self.last_v = nn.Parameter(torch.zeros(bottleneck, out_dim))
        self.last_g = nn.Parameter(torch.ones(out_dim))
        # after each hidden linear
        self.bn = (nn.ModuleList([BatchNormAffine(hidden),
                                  BatchNormAffine(hidden)])
                   if use_bn else None)


def _batch_norm(h: torch.Tensor, bn: BatchNormAffine,
                state: Dict[str, torch.Tensor], train: bool,
                total: Optional[Callable] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """BatchNorm1d over rows: (normalized at h's dtype, new state).

    Train mode normalizes by the batch mean and the BIASED batch variance,
    and feeds the UNBIASED one to the running variance (torch's
    semantics, momentum 0.1, eps 1e-5); gradients flow through the batch
    statistics.  A batch of one uses n / max(n - 1, 1), as the JAX
    package does (torch raises there).  Eval mode uses the running
    statistics.  The arithmetic is float32.  total: turns a sum over
    these rows into one over the whole batch (a data-parallel rank's
    `DataParallel.total`): the statistics then span every rank's rows, as
    under JAX's sharded jit (train/dino.py:374-379)."""
    h32 = h.float()
    if train and total is not None:
        n = int(total(torch.tensor(float(h.shape[0]),
                                   device=h.device)).item())
        mean = total(h32.sum(0)) / n
        var = total((h32 - mean).square().sum(0)) / n
    elif train:
        mean = h32.mean(0)
        var = (h32 - mean).square().mean(0)
        n = h.shape[0]
    if train:
        unbiased = var.detach() * (n / max(n - 1, 1))
        new_state = {
            "mean": (1 - _BN_MOMENTUM) * state["mean"]
            + _BN_MOMENTUM * mean.detach(),
            "var": (1 - _BN_MOMENTUM) * state["var"]
            + _BN_MOMENTUM * unbiased}
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    out = (h32 - mean) * torch.rsqrt(var + _BN_EPS)
    out = out * bn.scale.float() + bn.bias.float()
    return out.to(h.dtype), new_state


def dino_head_init(generator: torch.Generator, in_dim: int, out_dim: int,
                   hidden: int = 2048, bottleneck: int = 256,
                   use_bn: bool = False) -> DINOHead:
    """The reference init on the CPU: normal(0.02) weights truncated at the
    ABSOLUTE bounds +-2 (dino-main/utils.py trunc_normal_, in effect
    untruncated at std 0.02), zero biases, g = 1; with `use_bn` the
    BatchNorm scales 1 and biases 0."""
    head = DINOHead(in_dim, out_dim, hidden, bottleneck, use_bn)

    def trunc_normal_(t):
        with torch.no_grad():
            t.copy_((0.02 * torch.randn(t.shape, generator=generator))
                    .clamp_(-2.0, 2.0))

    for lin in head.mlp:
        trunc_normal_(lin.weight)
        nn.init.zeros_(lin.bias)
    trunc_normal_(head.last_v)
    return head


def dino_head_bn_init(head: DINOHead, device=None) -> BNState:
    """Fresh running statistics (mean 0, var 1, torch's defaults), one
    entry per BatchNorm of the head in layer order, shaped from the head's
    own parameters."""
    return [{"mean": torch.zeros_like(bn.scale, device=device).detach(),
             "var": torch.ones_like(bn.scale, device=device).detach()}
            for bn in (head.bn or ())]


def dino_head_bottleneck(head: DINOHead, x: torch.Tensor,
                         bn_state: Optional[BNState] = None,
                         train: bool = True,
                         total: Optional[Callable] = None):
    """MLP + L2 row normalization (vision_transformer.py:283-287).  The
    products run at x's dtype with the parameters cast at use, GELU in
    float32; the normalization divides by a float32 norm, so the result is
    float32 (as the JAX package's type promotion makes it).  A collapsed
    row yields zeros, not NaNs (F.normalize's eps 1e-12).

    A BatchNorm head needs `bn_state` (`dino_head_bn_init`).  Given a
    `bn_state`, the return is (h, new_bn_state), as in the JAX package
    also for a head without BatchNorm (whose new state is then []).
    total: the BatchNorm statistics over every data-parallel rank's rows
    (`_batch_norm`)."""
    h = x
    new_state = [] if bn_state is not None else None
    for i, lin in enumerate(head.mlp):
        h = torch.matmul(h, lin.weight.to(h.dtype).t()) + lin.bias.to(h.dtype)
        if head.bn is not None and i < len(head.bn):
            if bn_state is None:
                raise ValueError(
                    "use_bn head needs bn_state (dino_head_bn_init)")
            h, st = _batch_norm(h, head.bn[i], bn_state[len(new_state)],
                                train, total)
            new_state.append(st)
        if i < len(head.mlp) - 1:
            h = F.gelu(h.float()).to(x.dtype)
    norm = torch.linalg.vector_norm(h.float(), dim=-1, keepdim=True)
    h = h / torch.clamp(norm, min=1e-12)
    return h if new_state is None else (h, new_state)


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
                      norm_last_layer: bool = True,
                      bn_state: Optional[BNState] = None,
                      train: bool = True):
    """x: (B, in_dim) -> (B, out_dim) prototype logits, float32.  With bf16
    input the whole head runs at that precision: bf16 MLP products, then
    `dino_last_layer` on bf16 operands.  A BatchNorm head takes
    `bn_state`; given one, the return is (logits, new_bn_state)."""
    h = dino_head_bottleneck(head, x, bn_state, train)
    new_state = None
    if bn_state is not None:
        h, new_state = h
    out = dino_last_layer(h, head.last_v, head.last_g, norm_last_layer,
                          x.dtype == torch.bfloat16)
    return out if new_state is None else (out, new_state)
