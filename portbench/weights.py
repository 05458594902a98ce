"""Weights and inputs drawn on the device from the seed, in two large
calls (one normal, one uniform) cut into the tensors."""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import torch

Rule = Tuple  # ("normal", std) | ("uniform", lo, hi) | ("zeros",) | ("ones",)


def draw(shapes: Dict[str, Sequence[int]],
         rule: Callable[[str, Dict[str, Sequence[int]]], Rule],
         generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on the generator's device}, each drawn by
    rule(name, shapes)."""
    dev = generator.device
    sizes = {n: int(torch.Size(s).numel()) for n, s in shapes.items()}
    kinds = {n: rule(n, shapes) for n in shapes}
    need = {"normal": 0, "uniform": 0}
    for n, k in kinds.items():
        if k[0] in need:
            need[k[0]] += sizes[n]
    normal = torch.randn(need["normal"], generator=generator, device=dev)
    uniform = torch.rand(need["uniform"], generator=generator, device=dev)
    at = {"normal": 0, "uniform": 0}
    out = {}
    for n, shape in shapes.items():
        k = kinds[n]
        if k[0] == "zeros":
            out[n] = torch.zeros(shape, device=dev)
        elif k[0] == "ones":
            out[n] = torch.ones(shape, device=dev)
        else:
            src = normal if k[0] == "normal" else uniform
            t = src[at[k[0]]:at[k[0]] + sizes[n]].view(shape)
            at[k[0]] += sizes[n]
            out[n] = t * k[1] if k[0] == "normal" else k[1] + (k[2] - k[1]) * t
    return out


def vit_rule(name: str, shapes=None) -> Rule:
    """DINO's ViT init (vision_transformer.py:161-172): normal(0.02)
    weights and embeddings, zero biases, unit LayerNorm scales."""
    if name.endswith("bias"):
        return ("zeros",)
    if ".norm" in name or name.startswith("norm"):
        return ("ones",)
    return ("normal", 0.02)


def module_shapes(module: torch.nn.Module) -> Dict[str, Sequence[int]]:
    return {n: tuple(p.shape) for n, p in module.named_parameters()}


def load(module: torch.nn.Module, tensors: Dict[str, torch.Tensor]) -> None:
    """Copy the drawn tensors into a module's parameters of the same
    names (every parameter must be drawn)."""
    with torch.no_grad():
        for n, p in module.named_parameters():
            p.copy_(tensors[n])


def temporal_rule(name: str, shapes) -> Rule:
    """SAIS's init (prepare_model.py:47-96): uniform [0, 1) CLS tokens,
    positional tables and prototypes (torch.rand); in the encoders torch's
    TransformerEncoderLayer init (xavier-uniform in_proj, uniform
    +-1/sqrt(fan_in) out_proj and feed-forward weights, zero biases, unit
    LayerNorm); every other linear torch's default (weight and bias
    uniform +-1/sqrt(fan_in))."""
    last = name.rsplit(".", 1)[-1]
    if "." not in name:
        return ("uniform", 0.0, 1.0)
    if "_encoder." in name:
        if last.endswith("bias"):
            return ("zeros",)
        if ".norm" in name:
            return ("ones",)
        if last == "in_proj_weight":
            lim = (6.0 / sum(shapes[name])) ** 0.5
        else:
            lim = shapes[name][1] ** -0.5
        return ("uniform", -lim, lim)
    fan_in = shapes[name.rsplit(".", 1)[0] + ".weight"][1]
    return ("uniform", -fan_in ** -0.5, fan_in ** -0.5)
