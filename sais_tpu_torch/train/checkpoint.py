"""Training results and inference artifacts on disk (reference
train.py:105-121).

Counterpart of `sais_tpu/train/checkpoint.py`:

- `save_training_result`, `load_training_result` and
  `save_inference_artifacts`: pickles of numpy arrays, laid out as the JAX
  package writes them (params.pkl holds the JAX parameter pytree), so
  either package reads the other's: `sais decode --params-dir` decodes a
  fold the port trained, and the port's `decode` one the JAX package
  trained;
- `CheckpointManager`: DINO's epoch-numbered restartable checkpoints
  (utils.py:152-185, main_dino.py:468-479), written with torch.save.  It
  reads no orbax checkpoint of the JAX package.
"""

from __future__ import annotations

import os
import pickle
import re
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from sais_tpu_torch.port.weights import full_model_params_to_jax


def _host(obj: Any) -> Any:
    """Every leaf of a nest of dicts, lists and tuples as a numpy array,
    as `jax.tree.map(np.asarray, obj)` maps it (dict keys in sorted order,
    None kept)."""
    if obj is None:
        return None
    if isinstance(obj, dict):
        return {k: _host(obj[k]) for k in sorted(obj)}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host(x) for x in obj)
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    return np.asarray(obj)


class CheckpointManager:
    """Epoch-numbered restartable checkpoints: <directory>/<step>.pt, the
    newest max_to_keep kept.  A save writes a temporary file and renames
    it, so a crash never leaves a partial checkpoint under a step name."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def steps(self):
        found = (re.fullmatch(r"(\d+)\.pt", f)
                 for f in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def save(self, step: int, state: Any) -> None:
        tmp = self._path(step) + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, self._path(step))
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def restore_latest(self, template: Any) -> Tuple[Optional[int], Any]:
        """(step, state) of the newest checkpoint (tensors on the CPU), or
        (None, template) when nothing is saved yet (the reference's 'found
        checkpoint at ...' path, utils.py:160-165).  Unpickles: restore
        only checkpoints you trust."""
        steps = self.steps()
        if not steps:
            return None, template
        return steps[-1], torch.load(self._path(steps[-1]),
                                     map_location="cpu", weights_only=False)


def save_training_result(savepath: str, result: Dict[str, Any]) -> None:
    """The best-val snapshot under params/Fold_<k> (train.py:105-112):
    params.pkl (the JAX pytree of `result['model']`, a FullModel
    state_dict; with `result['encoder']`, a raw-path encoder already in
    JAX's layout, the joint {"model", "encoder"} tree the JAX package
    saves for an unfrozen encoder), prototypes.pkl and metrics.pkl."""
    os.makedirs(savepath, exist_ok=True)
    params = full_model_params_to_jax(result["model"])
    if result.get("encoder") is not None:
        params = {"model": params, "encoder": result["encoder"]}
    payloads = {"params": params,
                "prototypes": _host(result["prototypes"]),
                "metrics": result.get("metrics", {})}
    for name, obj in payloads.items():
        with open(os.path.join(savepath, name + ".pkl"), "wb") as f:
            pickle.dump(obj, f)


def load_training_result(savepath: str) -> Dict[str, Any]:
    """The pickles of a params/Fold_<k> directory, by name (params,
    prototypes, metrics), as written by either package.  Unpickles: load
    only folds you trust."""
    out = {}
    for name in ("params", "prototypes", "metrics"):
        p = os.path.join(savepath, f"{name}.pkl")
        if os.path.exists(p):
            with open(p, "rb") as f:
                out[name] = pickle.load(f)
    return out


def save_inference_artifacts(savepath: str, phase: str,
                             reps_and_labels: Dict[str, Any],
                             attention: Optional[Any] = None,
                             importance: Optional[Any] = None) -> None:
    """Reference inference outputs (train.py:113-121): reps_and_labels_<ph>,
    attention_<ph>, importance_<ph>, one pickle each under savepath."""
    os.makedirs(savepath, exist_ok=True)
    payloads = {f"reps_and_labels_{phase}": reps_and_labels}
    if attention is not None:
        payloads[f"attention_{phase}"] = attention
    if importance is not None:
        payloads[f"importance_{phase}"] = importance
    for name, obj in payloads.items():
        with open(os.path.join(savepath, name + ".pkl"), "wb") as f:
            pickle.dump(_host(obj), f)


# ---------------------------------------------------------------------------
# The reference's torch layout (the inverse of port.weights.
# full_model_params_from_torch; sais_tpu/train/checkpoint.py:106-166)
# ---------------------------------------------------------------------------

def export_torch_state_dict(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The JAX package's full_model pytree (params.pkl) -> the reference
    fullModel state_dict's names, numpy values (torch.save them for a
    params.zip).  Every key carries DataParallel's 'module.' prefix: the
    reference's inference loader strips it unconditionally
    (param_name.split('module.')[1], prepare_model.py:521-530) and raises
    IndexError on a bare name."""
    sd: Dict[str, np.ndarray] = {}

    def lin(prefix: str, p: Dict[str, Any]):
        sd[prefix + ".weight"] = np.asarray(p["w"]).T
        sd[prefix + ".bias"] = np.asarray(p["b"])

    sd["frame_cls"] = np.asarray(params["frame_cls"])[None]
    sd["clip_cls"] = np.asarray(params["clip_cls"])[None]
    for name, key in (("frame_pos_embeddings", "frame_pos"),
                      ("clip_pos_embeddings", "clip_pos")):
        table = np.asarray(params[key])
        for i in range(table.shape[0]):
            sd[f"{name}.{i}"] = table[i][None]
    for enc_name, key in (("transEncoderFrame", "frame_encoder"),
                          ("transEncoderClip", "clip_encoder")):
        for i, layer in enumerate(params[key]["layers"]):
            p = f"{enc_name}.layers.{i}."
            mha = layer["mha"]
            sd[p + "self_attn.in_proj_weight"] = np.asarray(mha["in_w"]).T
            sd[p + "self_attn.in_proj_bias"] = np.asarray(mha["in_b"])
            sd[p + "self_attn.out_proj.weight"] = np.asarray(mha["out_w"]).T
            sd[p + "self_attn.out_proj.bias"] = np.asarray(mha["out_b"])
            sd[p + "linear1.weight"] = np.asarray(layer["ff1_w"]).T
            sd[p + "linear1.bias"] = np.asarray(layer["ff1_b"])
            sd[p + "linear2.weight"] = np.asarray(layer["ff2_w"]).T
            sd[p + "linear2.bias"] = np.asarray(layer["ff2_b"])
            sd[p + "norm1.weight"] = np.asarray(layer["ln1_s"])
            sd[p + "norm1.bias"] = np.asarray(layer["ln1_b"])
            sd[p + "norm2.weight"] = np.asarray(layer["ln2_s"])
            sd[p + "norm2.bias"] = np.asarray(layer["ln2_b"])
    for name in ("linear", "linear2", "attentionA", "attentionB"):
        lin(name, params[name])
    for c, p in params.get("attention_modules", {}).items():
        lin(f"attentionModules.{c}", p)
    for c, p in params.get("final_modules", {}).items():
        lin(f"finalModules.{c}", p)
    for name, ref in (("importance", "importance_function"),
                      ("cls_head", "cls_head"), ("linearB", "linearB")):
        if name in params:
            lin(ref, params[name])
    return {"module." + k: v for k, v in sd.items()}


def export_torch_prototypes(keys: Sequence[str],
                            mat: Any) -> Dict[str, np.ndarray]:
    """Prototype matrix -> the reference's ParameterDict layout {key: (1,
    D)}."""
    mat = np.asarray(mat)
    return {k: mat[i][None] for i, k in enumerate(keys)}

