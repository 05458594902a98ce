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
from typing import Any, Dict, Optional, Tuple

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
    state_dict), prototypes.pkl and metrics.pkl."""
    os.makedirs(savepath, exist_ok=True)
    payloads = {"params": full_model_params_to_jax(result["model"]),
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
