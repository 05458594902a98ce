"""Inference artifacts on disk (reference train.py:113-121).

Counterpart of `save_inference_artifacts` in `sais_tpu/train/checkpoint.py`
(the rest of that module, orbax training checkpoints, waits for the
training slice).  The files are pickles of numpy arrays, laid out as the
JAX package writes them, so either package reads the other's.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional

import numpy as np
import torch


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
