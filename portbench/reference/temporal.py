"""SAIS's temporal model on stored representations and its prototype
training step (prepare_model.py, prepare_miscellaneous.py, train.py):
learned frame positions and a CLS token, torch's post-norm
`TransformerEncoderLayer` (ReLU, no dropout) with the key-padding mask,
ReLU, the CLS track averaged over snippets, ReLU, the linear projection,
cosine similarity to the prototypes, the InfoNCE loss, plain SGD over the
model and the prototypes."""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]


@contextlib.contextmanager
def math_attention():
    """torch's attention as written (scores, softmax, weighted sum), not a
    fused kernel with its own arithmetic."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    with sdpa_kernel(SDPBackend.MATH):
        yield


def encoder_layers(w: Weights, cfg: dict, device) -> List[nn.Module]:
    layers = []
    for i in range(cfg["num_layers"]):
        layer = nn.TransformerEncoderLayer(
            cfg["rep_dim"], cfg["num_heads"], cfg["ffn_dim"], dropout=0.0,
            activation="relu", layer_norm_eps=cfg["layernorm_eps"],
            batch_first=True, norm_first=False, device=device)
        prefix = f"frame_encoder.layers.{i}."
        layer.load_state_dict({k: w[prefix + k]
                               for k in layer.state_dict()})
        layers.append(layer)
    return layers


LEAVES_OUTSIDE = ("frame_cls", "frame_pos", "linear.weight", "linear.bias")


def loss_and_probs(w: Weights, layers, prototypes: torch.Tensor,
                   rgb: torch.Tensor, mask: torch.Tensor,
                   label_cols: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s, f, d = rgb.shape
    x = rgb + w["frame_pos"][:f]
    cls = w["frame_cls"].expand(b, s, 1, d)
    x = torch.cat([cls, x], dim=2).reshape(b * s, f + 1, d)
    m = mask.reshape(b * s, f + 1)
    for layer in layers:
        x = layer(x, src_key_padding_mask=m)
    track = torch.relu(x).reshape(b, s, f + 1, d)[:, :, 0].mean(dim=1)
    rep = F.linear(torch.relu(track), w["linear.weight"], w["linear.bias"])
    sim = F.normalize(rep, dim=-1, eps=0.0) @ F.normalize(
        prototypes, dim=-1, eps=0.0).t()
    logp = torch.log_softmax(sim, -1)
    loss = -logp.gather(1, label_cols.long()[:, None])[:, 0].mean()
    return loss, torch.softmax(sim.detach(), -1)


def train_steps(w: Weights, prototypes: torch.Tensor, cfg: dict,
                batches, lr: float):
    """Plain SGD steps from w over `batches` (dicts of device tensors):
    per step (loss, probabilities under the pre-update prototypes,
    {leaf: gradient}); then the leaves after the last step."""
    dev = prototypes.device
    layers = encoder_layers(w, cfg, dev)
    params = {n: w[n].clone().requires_grad_(True) for n in LEAVES_OUTSIDE}
    params["prototypes"] = prototypes.clone().requires_grad_(True)
    for i, layer in enumerate(layers):
        for k, p in layer.named_parameters():
            params[f"frame_encoder.layers.{i}.{k}"] = p
    out = []
    for batch in batches:
        for p in params.values():
            p.grad = None
        loss, probs = loss_and_probs(params, layers, params["prototypes"],
                                     batch["rgb"], batch["rgb_mask"],
                                     batch["label_cols"])
        loss.backward()
        grads = {n: (torch.zeros_like(p) if p.grad is None
                     else p.grad.detach().clone())
                 for n, p in params.items()}
        with torch.no_grad():
            for p in params.values():
                if p.grad is not None:
                    p -= lr * p.grad
        out.append((float(loss.detach()), probs, grads))
    return out, {n: p.detach() for n, p in params.items()}
