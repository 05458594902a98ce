"""HDF5 per-video feature store in the reference layout; h5py is imported
at first use.

Own copy of `sais_tpu/io/feature_store.py`: one dataset per video key,
shape (nframes, 384), in results/<model>_RepsAndLabels.h5 and, for the
flow stream, results/<model>_FlowRepsAndLabels.h5
(extract_representations.py:389-407).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

RGB_SUFFIX = "%s_RepsAndLabels.h5"
FLOW_SUFFIX = "%s_FlowRepsAndLabels.h5"
DEFAULT_MODEL_TYPE = "ViT_SelfSupervised_ImageNet"


class FeatureStore:
    """Read and write per-video feature matrices."""

    def __init__(self, path: str, mode: str = "r"):
        import h5py
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._h5 = h5py.File(path, mode)
        self.path = path

    def write_video(self, video: str, reps: np.ndarray,
                    attrs: Optional[Dict[str, object]] = None) -> None:
        """attrs: per-video metadata kept as HDF5 dataset attributes (the
        flow pair stride `flow` extracted at); readers of the reference
        layout ignore them."""
        if video in self._h5:
            del self._h5[video]
        ds = self._h5.create_dataset(video, data=np.asarray(reps))
        for k, v in (attrs or {}).items():
            ds.attrs[k] = v

    def video_attr(self, video: str, key: str):
        """Per-video metadata (see write_video); None when absent."""
        if video not in self._h5:
            return None
        val = self._h5[video].attrs.get(key)
        return None if val is None else val.item() if hasattr(
            val, "item") else val

    def read_video(self, video: str) -> np.ndarray:
        return np.asarray(self._h5[video])

    def videos(self) -> List[str]:
        return list(self._h5.keys())

    def __contains__(self, video: str) -> bool:
        return video in self._h5

    def close(self) -> None:
        self._h5.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def rgb_store_path(root: str, model_type: str = DEFAULT_MODEL_TYPE) -> str:
    return os.path.join(root, "results", RGB_SUFFIX % model_type)


def flow_store_path(root: str, model_type: str = DEFAULT_MODEL_TYPE) -> str:
    return os.path.join(root, "results", FLOW_SUFFIX % model_type)
