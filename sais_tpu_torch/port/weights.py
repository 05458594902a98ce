"""Weights carried into the port's modules.

- `vit_params_from_jax` / `full_model_params_from_jax`: JAX parameter
  pytrees (leaves as numpy arrays) -> state_dicts of
  `models.vit.VisionTransformer` / `models.full_model.FullModel` (every
  member: frame and clip encoders and tables, the projections, the MIL
  modules and the optional heads).  JAX stores linear weights (in, out);
  torch stores (out, in).
  `full_model_params_to_jax` is the inverse of the latter (the
  `params.pkl` the port's `train` writes).
- `vit_params_to_jax`, `r3d18_state_from_jax` / `r3d18_params_to_jax`:
  the ViT and the R3D-18 encoder the other way and both ways (an
  unfrozen raw-path encoder is saved in JAX's layout);
- `load_dino_weights`: DINO `.pth` (dino_deitsmall16_pretrain.pth or a
  surgical pre-training checkpoint) -> VisionTransformer state_dict.
- `full_model_params_from_reference` / `prototypes_from_reference`: the
  reference's `params.zip` / `prototypes.zip` (prepare_model.py:521-564).
- `dino_head_params_from_jax` / `dino_head_params_to_jax` /
  `dino_state_from_jax`: the JAX package's DINO head pytree (BatchNorm
  scale / bias included) and `DINOTrainer.state()` (student and teacher
  {"backbone", "head"} trees, the center and a use_bn head's running
  statistics) <-> state_dicts of `models.dino_head.DINOHead` and of the
  port trainer's student / teacher `nn.ModuleDict`s;
  `dino_head_params_from_reference` / `dino_head_bn_state_from_reference`:
  the reference's DINOHead state_dict (mlp.0/2/4, or 0/3/6 with
  BatchNorm1d at 1 / 4).
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


def vit_params_to_jax(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """VisionTransformer state_dict -> `sais_tpu.models.vit` params
    (numpy leaves), the inverse of `vit_params_from_jax`."""
    pe = _np(sd["patch_embed.proj.weight"])           # (D, C, kh, kw)
    tree: Dict[str, Any] = {
        "cls_token": _np(sd["cls_token"]), "pos_embed": _np(sd["pos_embed"]),
        "patch_embed": {"w": np.ascontiguousarray(
            pe.transpose(2, 3, 1, 0).reshape(-1, pe.shape[0])),
            "b": _np(sd["patch_embed.proj.bias"])},
        "ln_s": _np(sd["norm.weight"]), "ln_b": _np(sd["norm.bias"]),
        "blocks": []}
    depth = 1 + max(int(k.split(".")[1]) for k in sd
                    if k.startswith("blocks."))
    for i in range(depth):
        p = f"blocks.{i}."
        attn = {"qkv_w": _npT(sd[p + "attn.qkv.weight"]),
                "proj_w": _npT(sd[p + "attn.proj.weight"]),
                "proj_b": _np(sd[p + "attn.proj.bias"])}
        if p + "attn.qkv.bias" in sd:
            attn["qkv_b"] = _np(sd[p + "attn.qkv.bias"])
        tree["blocks"].append({
            "ln1_s": _np(sd[p + "norm1.weight"]),
            "ln1_b": _np(sd[p + "norm1.bias"]), "attn": attn,
            "ln2_s": _np(sd[p + "norm2.weight"]),
            "ln2_b": _np(sd[p + "norm2.bias"]),
            "mlp": {"fc1_w": _npT(sd[p + "mlp.fc1.weight"]),
                    "fc1_b": _np(sd[p + "mlp.fc1.bias"]),
                    "fc2_w": _npT(sd[p + "mlp.fc2.weight"]),
                    "fc2_b": _np(sd[p + "mlp.fc2.bias"])}})
    return tree


def _linear_from_jax(p: Mapping[str, Any], prefix: str) -> StateDict:
    return {prefix + "weight": _t(np.asarray(p["w"]).T),
            prefix + "bias": _t(p["b"])}


def dino_head_params_from_jax(tree: Mapping[str, Any]) -> StateDict:
    """`sais_tpu.models.dino_head` params -> DINOHead state_dict (last_v
    keeps the JAX (bottleneck, out_dim) layout; a use_bn head's BatchNorm
    scale / bias go to bn.<i>)."""
    sd: StateDict = {"last_v": _t(tree["last_v"]),
                     "last_g": _t(tree["last_g"])}
    for i, layer in enumerate(tree["mlp"]):
        sd.update(_linear_from_jax(layer, f"mlp.{i}."))
        if "bn" in layer:
            sd[f"bn.{i}.scale"] = _t(layer["bn"]["scale"])
            sd[f"bn.{i}.bias"] = _t(layer["bn"]["bias"])
    return sd


def dino_head_params_to_jax(sd: Mapping[str, torch.Tensor]
                            ) -> Dict[str, Any]:
    """The inverse of `dino_head_params_from_jax` (leaves as numpy)."""
    mlp = []
    for i in range(3):
        layer = {"w": _npT(sd[f"mlp.{i}.weight"]),
                 "b": _np(sd[f"mlp.{i}.bias"])}
        if f"bn.{i}.scale" in sd:
            layer["bn"] = {"scale": _np(sd[f"bn.{i}.scale"]),
                           "bias": _np(sd[f"bn.{i}.bias"])}
        mlp.append(layer)
    return {"mlp": mlp, "last_v": _np(sd["last_v"]),
            "last_g": _np(sd["last_g"])}


def dino_head_params_from_reference(sd: Mapping[str, Any], prefix: str = ""
                                    ) -> StateDict:
    """The reference's DINOHead state_dict (vision_transformer.py:257-291:
    mlp.0 / 2 / 4 linears, or 0 / 3 / 6 with BatchNorm1d at 1 and 4 for
    --use_bn_in_head; the weight-normed last_layer as weight_g / weight_v
    or torch's parametrization keys) -> DINOHead state_dict.  The
    BatchNorms' running statistics come through
    `dino_head_bn_state_from_reference`."""
    use_bn = f"{prefix}mlp.1.running_mean" in sd
    out: StateDict = {}
    for j, i in enumerate((0, 3, 6) if use_bn else (0, 2, 4)):
        out[f"mlp.{j}.weight"] = _f32(sd[f"{prefix}mlp.{i}.weight"])
        out[f"mlp.{j}.bias"] = _f32(sd[f"{prefix}mlp.{i}.bias"])
        if use_bn and j < 2:
            out[f"bn.{j}.scale"] = _f32(sd[f"{prefix}mlp.{i + 1}.weight"])
            out[f"bn.{j}.bias"] = _f32(sd[f"{prefix}mlp.{i + 1}.bias"])
    g = sd.get(f"{prefix}last_layer.weight_g",
               sd.get(f"{prefix}last_layer.parametrizations.weight.original0"))
    v = sd.get(f"{prefix}last_layer.weight_v",
               sd.get(f"{prefix}last_layer.parametrizations.weight.original1"))
    out["last_v"] = _f32(v).t().contiguous()       # (bottleneck, out_dim)
    out["last_g"] = _f32(g).reshape(-1)
    return out


def dino_head_bn_state_from_reference(sd: Mapping[str, Any],
                                      prefix: str = ""
                                      ) -> List[Dict[str, torch.Tensor]]:
    """The running statistics of a use_bn reference DINOHead (mlp.1 /
    mlp.4 running_mean / running_var), copied, in layer order."""
    return [{"mean": _f32(sd[f"{prefix}mlp.{i}.running_mean"]).clone(),
             "var": _f32(sd[f"{prefix}mlp.{i}.running_var"]).clone()}
            for i in (1, 4) if f"{prefix}mlp.{i}.running_mean" in sd]


def dino_state_from_jax(state: Mapping[str, Any]) -> Dict[str, Any]:
    """A JAX `DINOTrainer.state()` (leaves as numpy) -> {"student":
    state_dict, "teacher": state_dict, "center": tensor} for the port's
    DINOTrainer (`trainer.student.load_state_dict(...)`), plus
    "student_bn" / "teacher_bn" (lists of {"mean", "var"}) for a use_bn
    head.  The optimizer state is not carried over: both trainers start
    it fresh."""
    out: Dict[str, Any] = {"center": _t(state["center"])}
    for net in ("student", "teacher"):
        sd = {"backbone." + k: v for k, v in
              vit_params_from_jax(state[net]["backbone"]).items()}
        sd.update({"head." + k: v for k, v in
                   dino_head_params_from_jax(state[net]["head"]).items()})
        out[net] = sd
        if state.get(f"{net}_bn") is not None:
            out[f"{net}_bn"] = [{k: _t(v) for k, v in st.items()}
                                for st in state[f"{net}_bn"]]
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


# the members decoding does not read (the MIL task's)
_MIL_MEMBERS = ("clip_cls", "clip_pos", "clip_encoder", "attentionA",
                "attentionB", "attention_modules", "final_modules")


def full_model_from_state(sd: Mapping[str, torch.Tensor], mcfg,
                          what: str = "checkpoint"):
    """A FullModel (float32, CPU) holding a state_dict: it keeps the
    checkpoint's own positional-table length, and has the importance,
    linearB and cls_head members exactly when the checkpoint has them, as
    the JAX package does.  A fold without the clip and MIL members (the
    port's Prototypes folds before it carried them) loads with those
    members zero.  mcfg: the ModelConfig the rest comes from."""
    import dataclasses
    from sais_tpu_torch.models.full_model import FullModel
    mcfg = dataclasses.replace(
        mcfg, importance_head="importance.weight" in sd,
        multi_task="linearB.weight" in sd,
        temporal=dataclasses.replace(
            mcfg.temporal, max_positions=len(sd["frame_pos"])))
    if "cls_head.weight" in sd:
        mcfg = dataclasses.replace(mcfg, data_type="raw",
                                   nclasses=len(sd["cls_head.weight"]))
    nmil = len({k.split(".")[1] for k in sd
                if k.startswith("final_modules.")})
    if nmil:
        mcfg = dataclasses.replace(mcfg, n_attention_classes=nmil)
    model = FullModel(mcfg)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    absent = [k for k in missing if k.split(".")[0] not in _MIL_MEMBERS]
    if absent or unexpected:
        raise RuntimeError(f"{what}: missing {absent}, unexpected "
                           f"{unexpected}")
    with torch.no_grad():
        for name in missing:
            model.get_parameter(name).zero_()
    return model


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


def r3d18_state_from_jax(params: Mapping[str, Any]) -> StateDict:
    """`sais_tpu.models.r3d` params (convolutions (D, H, W, I, O), frozen
    BatchNorms {w, b, rm, rv}) -> `models.r3d.R3D18` state_dict."""
    sd: StateDict = {}

    def conv(p, name):
        sd[name + ".w"] = _t(np.asarray(p["w"]).transpose(4, 3, 0, 1, 2))

    def bn(p, name):
        for k in ("w", "b", "rm", "rv"):
            sd[f"{name}.{k}"] = _t(p[k])

    conv(params["stem"], "stem")
    bn(params["stem_bn"], "stem_bn")
    for li, stage in enumerate(params["layers"]):
        for bi, blk in enumerate(stage):
            p = f"layers.{li}.{bi}"
            conv(blk["conv1"], p + ".conv1")
            bn(blk["bn1"], p + ".bn1")
            conv(blk["conv2"], p + ".conv2")
            bn(blk["bn2"], p + ".bn2")
            if "down" in blk:
                conv(blk["down"], p + ".down")
                bn(blk["down_bn"], p + ".down_bn")
    return sd


def r3d18_params_to_jax(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """`models.r3d.R3D18` state_dict -> `sais_tpu.models.r3d` params
    (numpy leaves), the inverse of `r3d18_state_from_jax`."""

    def conv(name):
        return {"w": np.ascontiguousarray(
            _np(sd[name + ".w"]).transpose(2, 3, 4, 1, 0))}

    def bn(name):
        return {k: _np(sd[f"{name}.{k}"]) for k in ("w", "b", "rm", "rv")}

    layers = []
    for li in range(4):
        blocks = []
        for bi in range(2):
            p = f"layers.{li}.{bi}"
            blk = {"conv1": conv(p + ".conv1"), "bn1": bn(p + ".bn1"),
                   "conv2": conv(p + ".conv2"), "bn2": bn(p + ".bn2")}
            if p + ".down.w" in sd:
                blk["down"] = conv(p + ".down")
                blk["down_bn"] = bn(p + ".down_bn")
            blocks.append(blk)
        layers.append(blocks)
    return {"stem": conv("stem"), "stem_bn": bn("stem_bn"),
            "layers": layers}


def full_model_params_from_torch(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Reference fullModel state_dict (params.zip) -> the JAX package's
    full_model pytree with numpy leaves, as `sais_tpu.port.torch_port.
    full_model_params_from_torch` gives it (the layout of params.pkl):
    every member the checkpoint has, and the MIL groups, empty where it
    has none."""
    tree = full_model_params_to_jax(full_model_params_from_reference(sd))
    for group in _CLASS_GROUPS:
        tree.setdefault(group, {})
    return tree


def prototypes_from_torch(protos: Mapping[str, Any]
                          ) -> Tuple[List[str], np.ndarray]:
    """prototypes.zip ParameterDict -> (keys in insertion order, (P, 256)
    float32 numpy), the layout of prototypes.pkl."""
    keys, mat = prototypes_from_reference(protos)
    return keys, mat.numpy()

