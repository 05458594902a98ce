"""Weights carried into the port's modules.

- `vit_params_from_jax` / `full_model_params_from_jax`: JAX parameter
  pytrees (leaves as numpy arrays) -> state_dicts of
  `models.vit.VisionTransformer` / `models.full_model.FullModel`.  JAX
  stores linear weights (in, out); torch stores (out, in).
- `load_dino_weights`: DINO `.pth` (dino_deitsmall16_pretrain.pth or a
  surgical pre-training checkpoint) -> VisionTransformer state_dict.
- `full_model_params_from_reference` / `prototypes_from_reference`: the
  reference's `params.zip` / `prototypes.zip` (prepare_model.py:521-564).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def _t(x: Any) -> torch.Tensor:
    """A JAX or numpy array -> float32 tensor."""
    return torch.as_tensor(np.array(x, dtype=np.float32))


def _f32(x: Any) -> torch.Tensor:
    """A checkpoint tensor -> detached float32 tensor."""
    return torch.as_tensor(x).detach().float()


def vit_params_from_jax(tree: Mapping[str, Any], in_channels: int = 3
                        ) -> StateDict:
    """`sais_tpu.models.vit` params -> VisionTransformer state_dict."""
    pe_w = np.asarray(tree["patch_embed"]["w"])       # (kh*kw*C, D)
    d = pe_w.shape[1]
    patch = int(round((pe_w.shape[0] / in_channels) ** 0.5))
    sd: StateDict = {
        "cls_token": _t(tree["cls_token"]),
        "pos_embed": _t(tree["pos_embed"]),
        "patch_embed.proj.weight": _t(pe_w.reshape(
            patch, patch, in_channels, d).transpose(3, 2, 0, 1)),
        "patch_embed.proj.bias": _t(tree["patch_embed"]["b"]),
        "norm.weight": _t(tree["ln_s"]),
        "norm.bias": _t(tree["ln_b"]),
    }
    for i, blk in enumerate(tree["blocks"]):
        p = f"blocks.{i}."
        attn, mlp = blk["attn"], blk["mlp"]
        sd.update({
            p + "norm1.weight": _t(blk["ln1_s"]),
            p + "norm1.bias": _t(blk["ln1_b"]),
            p + "attn.qkv.weight": _t(np.asarray(attn["qkv_w"]).T),
            p + "attn.proj.weight": _t(np.asarray(attn["proj_w"]).T),
            p + "attn.proj.bias": _t(attn["proj_b"]),
            p + "norm2.weight": _t(blk["ln2_s"]),
            p + "norm2.bias": _t(blk["ln2_b"]),
            p + "mlp.fc1.weight": _t(np.asarray(mlp["fc1_w"]).T),
            p + "mlp.fc1.bias": _t(mlp["fc1_b"]),
            p + "mlp.fc2.weight": _t(np.asarray(mlp["fc2_w"]).T),
            p + "mlp.fc2.bias": _t(mlp["fc2_b"]),
        })
        if attn.get("qkv_b") is not None:
            sd[p + "attn.qkv.bias"] = _t(attn["qkv_b"])
    return sd


def _linear_from_jax(p: Mapping[str, Any], prefix: str) -> StateDict:
    return {prefix + "weight": _t(np.asarray(p["w"]).T),
            prefix + "bias": _t(p["b"])}


def full_model_params_from_jax(tree: Mapping[str, Any]) -> StateDict:
    """`sais_tpu.models.full_model` params -> FullModel state_dict (the
    parts the Prototypes inference path reads)."""
    sd: StateDict = {"frame_cls": _t(tree["frame_cls"]),
                     "frame_pos": _t(tree["frame_pos"])}
    for i, layer in enumerate(tree["frame_encoder"]["layers"]):
        p = f"frame_encoder.layers.{i}."
        mha = layer["mha"]
        sd.update({
            p + "self_attn.in_proj_weight": _t(np.asarray(mha["in_w"]).T),
            p + "self_attn.in_proj_bias": _t(mha["in_b"]),
            p + "self_attn.out_proj.weight": _t(np.asarray(mha["out_w"]).T),
            p + "self_attn.out_proj.bias": _t(mha["out_b"]),
            p + "linear1.weight": _t(np.asarray(layer["ff1_w"]).T),
            p + "linear1.bias": _t(layer["ff1_b"]),
            p + "linear2.weight": _t(np.asarray(layer["ff2_w"]).T),
            p + "linear2.bias": _t(layer["ff2_b"]),
            p + "norm1.weight": _t(layer["ln1_s"]),
            p + "norm1.bias": _t(layer["ln1_b"]),
            p + "norm2.weight": _t(layer["ln2_s"]),
            p + "norm2.bias": _t(layer["ln2_b"]),
        })
    sd.update(_linear_from_jax(tree["linear"], "linear."))
    sd.update(_linear_from_jax(tree["linear2"], "linear2."))
    return sd


def load_checkpoint(path: str) -> Any:
    """Read a torch.save artifact.  The reference's checkpoints hold more
    than tensors (DINO's saved args, ParameterDicts), so this unpickles:
    load only checkpoints you trust."""
    return torch.load(path, map_location="cpu", weights_only=False)


def strip_module_prefix(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Strip DataParallel's 'module.' prefix (prepare_model.py:524-527)."""
    return {(k.split("module.", 1)[1] if k.startswith("module.") else k): v
            for k, v in sd.items()}


def strip_dino_prefixes(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Backbone weights under bare DINO names: unwrap a full training
    checkpoint's 'student' dict, drop the projection head and strip the
    'student.' / 'teacher.' / 'module.' / 'backbone.' prefixes
    (extract_representations.py:190-199)."""
    if "student" in sd and hasattr(sd["student"], "items"):
        sd = sd["student"]
    out = {}
    for k, v in sd.items():
        if "head" in k:
            continue
        parts = k.split(".")
        while parts and parts[0] in ("student", "teacher", "module",
                                     "backbone"):
            parts = parts[1:]
        out[".".join(parts)] = v
    return out


def load_dino_weights(path: str) -> StateDict:
    """DINO checkpoint -> VisionTransformer state_dict."""
    return strip_dino_prefixes(load_checkpoint(path))


def _pos_table(sd: Mapping[str, Any], prefix: str) -> torch.Tensor:
    """ParameterDict {str(i): (1, D)} (prepare_model.py:65-71) -> (N, D)."""
    idx = sorted(int(k[len(prefix):]) for k in sd if k.startswith(prefix))
    return torch.stack([_f32(sd[f"{prefix}{i}"]).reshape(-1) for i in idx])


def full_model_params_from_reference(sd: Mapping[str, Any]) -> StateDict:
    """Reference fullModel state_dict (params.zip) -> FullModel state_dict.
    The frame encoder keeps torch's TransformerEncoder names, so its keys
    move across as they are."""
    sd = strip_module_prefix(sd)
    out: StateDict = {
        "frame_cls": _f32(sd["frame_cls"]).reshape(-1),
        "frame_pos": _pos_table(sd, "frame_pos_embeddings."),
    }
    enc = "transEncoderFrame."
    for k, v in sd.items():
        if k.startswith(enc):
            out["frame_encoder." + k[len(enc):]] = _f32(v)
        elif k.split(".")[0] in ("linear", "linear2"):
            out[k] = _f32(v)
    return out


def prototypes_from_reference(protos: Mapping[str, Any]
                              ) -> Tuple[List[str], torch.Tensor]:
    """prototypes.zip ParameterDict -> (keys in insertion order, (P, 256)),
    as torch.vstack(list(prototypes.values())) (prepare_miscellaneous.py:16)."""
    keys = list(protos.keys())
    return keys, torch.stack([_f32(protos[k]).reshape(-1) for k in keys])
