"""Weights carried into the port's modules.

- `vit_params_from_jax` / `full_model_params_from_jax`: JAX parameter
  pytrees (leaves as numpy arrays) -> state_dicts of
  `models.vit.VisionTransformer` / `models.full_model.FullModel` (every
  member: frame and clip encoders and tables, the projections, the MIL
  modules and the optional heads).  JAX stores linear weights (in, out);
  torch stores (out, in).
  `full_model_params_to_jax` is the inverse of the latter (the
  `params.pkl` the port's `train` writes).
- `load_dino_weights`: DINO `.pth` (dino_deitsmall16_pretrain.pth or a
  surgical pre-training checkpoint) -> VisionTransformer state_dict.
- `full_model_params_from_reference` / `prototypes_from_reference`: the
  reference's `params.zip` / `prototypes.zip` (prepare_model.py:521-564).
- `dino_head_params_from_jax` / `dino_state_from_jax`: the JAX package's
  DINO head pytree and `DINOTrainer.state()` (student and teacher
  {"backbone", "head"} trees and the center) -> state_dicts of
  `models.dino_head.DINOHead` and of the port trainer's student / teacher
  `nn.ModuleDict`s.
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


def dino_head_params_from_jax(tree: Mapping[str, Any]) -> StateDict:
    """`sais_tpu.models.dino_head` params -> DINOHead state_dict (last_v
    keeps the JAX (bottleneck, out_dim) layout)."""
    if any("bn" in layer for layer in tree["mlp"]):
        raise NotImplementedError(
            "a use_bn DINO head is not ported yet (next slice)")
    sd: StateDict = {"last_v": _t(tree["last_v"]),
                     "last_g": _t(tree["last_g"])}
    for i, layer in enumerate(tree["mlp"]):
        sd.update(_linear_from_jax(layer, f"mlp.{i}."))
    return sd


def dino_state_from_jax(state: Mapping[str, Any]) -> Dict[str, Any]:
    """A JAX `DINOTrainer.state()` (leaves as numpy) -> {"student":
    state_dict, "teacher": state_dict, "center": tensor} for the port's
    DINOTrainer (`trainer.student.load_state_dict(...)`).  The optimizer
    state is not carried over: both trainers start it fresh."""
    out: Dict[str, Any] = {"center": _t(state["center"])}
    for net in ("student", "teacher"):
        sd = {"backbone." + k: v for k, v in
              vit_params_from_jax(state[net]["backbone"]).items()}
        sd.update({"head." + k: v for k, v in
                   dino_head_params_from_jax(state[net]["head"]).items()})
        out[net] = sd
    return out


def _encoder_from_jax(layers, prefix: str) -> StateDict:
    sd: StateDict = {}
    for i, layer in enumerate(layers):
        p = f"{prefix}.layers.{i}."
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
    return sd


# the linear members of a FullModel that a tree may hold, with the per-class
# MIL modules under <group>.<class>
_LINEARS = ("linear", "linear2", "importance", "linearB", "attentionA",
            "attentionB", "cls_head")
_CLASS_GROUPS = ("attention_modules", "final_modules")


def full_model_params_from_jax(tree: Mapping[str, Any]) -> StateDict:
    """`sais_tpu.models.full_model` params -> FullModel state_dict: every
    member the tree has (a fold the port wrote before it carried the clip
    and MIL members has only the Prototypes path's; `load_fold` takes
    that)."""
    sd: StateDict = {"frame_cls": _t(tree["frame_cls"]),
                     "frame_pos": _t(tree["frame_pos"])}
    sd.update(_encoder_from_jax(tree["frame_encoder"]["layers"],
                                "frame_encoder"))
    for name in ("clip_cls", "clip_pos"):
        if name in tree:
            sd[name] = _t(tree[name])
    if "clip_encoder" in tree:
        sd.update(_encoder_from_jax(tree["clip_encoder"]["layers"],
                                    "clip_encoder"))
    for name in _LINEARS:
        if name in tree:
            sd.update(_linear_from_jax(tree[name], name + "."))
    for group in _CLASS_GROUPS:
        for c, lin in tree.get(group, {}).items():
            sd.update(_linear_from_jax(lin, f"{group}.{c}."))
    return sd


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().float().numpy()


def _npT(t: torch.Tensor) -> np.ndarray:
    """A torch (out, in) linear weight -> the JAX (in, out) layout."""
    return np.ascontiguousarray(_np(t).T)


def _encoder_to_jax(sd: Mapping[str, torch.Tensor], prefix: str
                    ) -> Dict[str, Any]:
    nlayers = 1 + max(int(k.split(".")[2]) for k in sd
                      if k.startswith(prefix + ".layers."))
    layers = []
    for i in range(nlayers):
        p = f"{prefix}.layers.{i}."
        layers.append({
            "mha": {"in_w": _npT(sd[p + "self_attn.in_proj_weight"]),
                    "in_b": _np(sd[p + "self_attn.in_proj_bias"]),
                    "out_w": _npT(sd[p + "self_attn.out_proj.weight"]),
                    "out_b": _np(sd[p + "self_attn.out_proj.bias"])},
            "ff1_w": _npT(sd[p + "linear1.weight"]),
            "ff1_b": _np(sd[p + "linear1.bias"]),
            "ff2_w": _npT(sd[p + "linear2.weight"]),
            "ff2_b": _np(sd[p + "linear2.bias"]),
            "ln1_s": _np(sd[p + "norm1.weight"]),
            "ln1_b": _np(sd[p + "norm1.bias"]),
            "ln2_s": _np(sd[p + "norm2.weight"]),
            "ln2_b": _np(sd[p + "norm2.bias"]),
        })
    return {"layers": layers}


def full_model_params_to_jax(sd: Mapping[str, torch.Tensor]
                             ) -> Dict[str, Any]:
    """FullModel state_dict -> `sais_tpu.models.full_model` params pytree
    (numpy leaves), the inverse of `full_model_params_from_jax`: every
    member the model has, in the JAX package's layout."""
    tree = {"frame_cls": _np(sd["frame_cls"]),
            "frame_pos": _np(sd["frame_pos"]),
            "frame_encoder": _encoder_to_jax(sd, "frame_encoder")}
    for name in ("clip_cls", "clip_pos"):
        if name in sd:
            tree[name] = _np(sd[name])
    if any(k.startswith("clip_encoder.") for k in sd):
        tree["clip_encoder"] = _encoder_to_jax(sd, "clip_encoder")
    for name in _LINEARS:
        if name + ".weight" in sd:
            tree[name] = {"w": _npT(sd[name + ".weight"]),
                          "b": _np(sd[name + ".bias"])}
    for group in _CLASS_GROUPS:
        classes = sorted({k.split(".")[1] for k in sd
                          if k.startswith(group + ".")}, key=int)
        if classes:
            tree[group] = {c: {"w": _npT(sd[f"{group}.{c}.weight"]),
                               "b": _np(sd[f"{group}.{c}.bias"])}
                           for c in classes}
    return tree


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


# reference fullModel names (prepare_model.py:47-101) -> FullModel names
_REFERENCE_PREFIXES = (("transEncoderFrame.", "frame_encoder."),
                       ("transEncoderClip.", "clip_encoder."),
                       ("importance_function.", "importance."),
                       ("attentionModules.", "attention_modules."),
                       ("finalModules.", "final_modules."))


def full_model_params_from_reference(sd: Mapping[str, Any]) -> StateDict:
    """Reference fullModel state_dict (params.zip) -> FullModel state_dict
    (torch_port.py:170-204).  The encoders keep torch's TransformerEncoder
    names, so their keys move across under the port's prefixes;
    importance_function.* becomes importance.*, attentionModules.* and
    finalModules.* attention_modules.* and final_modules.*; linear,
    linear2, linearB, attentionA, attentionB and cls_head stay."""
    sd = strip_module_prefix(sd)
    out: StateDict = {
        "frame_cls": _f32(sd["frame_cls"]).reshape(-1),
        "frame_pos": _pos_table(sd, "frame_pos_embeddings."),
    }
    if "clip_cls" in sd:
        out["clip_cls"] = _f32(sd["clip_cls"]).reshape(-1)
    if any(k.startswith("clip_pos_embeddings.") for k in sd):
        out["clip_pos"] = _pos_table(sd, "clip_pos_embeddings.")
    for k, v in sd.items():
        for ref, port in _REFERENCE_PREFIXES:
            if k.startswith(ref):
                out[port + k[len(ref):]] = _f32(v)
        if k.split(".")[0] in _LINEARS:
            out[k] = _f32(v)
    return out


def prototypes_from_reference(protos: Mapping[str, Any]
                              ) -> Tuple[List[str], torch.Tensor]:
    """prototypes.zip ParameterDict -> (keys in insertion order, (P, 256)),
    as torch.vstack(list(prototypes.values())) (prepare_miscellaneous.py:16)."""
    keys = list(protos.keys())
    return keys, torch.stack([_f32(protos[k]).reshape(-1) for k in keys])


def raft_state_from_reference(sd: Mapping[str, Any]) -> StateDict:
    """RAFT checkpoint (princeton-vl or ptlflow naming: fnet.*, cnet.*,
    update_block.*) -> `models.raft.RAFT` state_dict.  Takes a
    {'state_dict': ...} wrapper and a 'model.' or 'module.' prefix, and the
    third norm of a residual block as downsample.1 or norm3 (the reference
    registers the module under both names); num_batches_tracked is
    dropped (the port's batch norms are frozen)."""
    if "state_dict" in sd:
        sd = sd["state_dict"]
    out: StateDict = {}
    for k, v in sd.items():
        head, _, rest = k.partition(".")
        if head in ("model", "module"):
            k = rest
        if k.endswith("num_batches_tracked"):
            continue
        if ".norm3." in k:
            out.setdefault(k.replace(".norm3.", ".downsample.1."), _f32(v))
        else:
            out[k] = _f32(v)
    return out


def _conv_from_jax(p: Mapping[str, Any], prefix: str) -> StateDict:
    """HWIO kernel -> OIHW weight, and the bias."""
    return {prefix + "weight": _t(np.asarray(p["w"]).transpose(3, 2, 0, 1)),
            prefix + "bias": _t(p["b"])}


def _bn_from_jax(p: Mapping[str, Any], prefix: str) -> StateDict:
    return {prefix + name: _t(p[key]) for name, key in
            (("weight", "w"), ("bias", "b"), ("running_mean", "rm"),
             ("running_var", "rv"))}


def raft_state_from_jax(params: Mapping[str, Any]) -> StateDict:
    """`sais_tpu.models.raft` params pytree (numpy leaves) -> RAFT
    state_dict."""
    sd: StateDict = {}
    for enc in ("fnet", "cnet"):
        tree = params[enc]
        sd.update(_conv_from_jax(tree["conv1"], f"{enc}.conv1."))
        sd.update(_conv_from_jax(tree["conv2"], f"{enc}.conv2."))
        if "norm1" in tree:
            sd.update(_bn_from_jax(tree["norm1"], f"{enc}.norm1."))
        for i in (1, 2, 3):
            for j, blk in enumerate(tree[f"layer{i}"]):
                p = f"{enc}.layer{i}.{j}."
                for name, fn in (("conv1", _conv_from_jax),
                                 ("conv2", _conv_from_jax),
                                 ("norm1", _bn_from_jax),
                                 ("norm2", _bn_from_jax),
                                 ("down", _conv_from_jax),
                                 ("norm3", _bn_from_jax)):
                    if name in blk:
                        dest = {"down": "downsample.0",
                                "norm3": "downsample.1"}.get(name, name)
                        sd.update(fn(blk[name], f"{p}{dest}."))
    u, upd = "update_block.", params["update"]
    for group in ("encoder", "gru", "flow_head"):
        for name, conv in upd[group].items():
            sd.update(_conv_from_jax(conv, f"{u}{group}.{name}."))
    sd.update(_conv_from_jax(upd["mask0"], u + "mask.0."))
    sd.update(_conv_from_jax(upd["mask2"], u + "mask.2."))
    return sd
