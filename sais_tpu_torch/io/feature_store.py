"""HDF5 per-video feature store in the reference layout; h5py is imported
at first use.

Own copy of `sais_tpu/io/feature_store.py`: one dataset per video key,
shape (nframes, 384), in results/<model>_RepsAndLabels.h5
(extract_representations.py:389-407).
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

RGB_SUFFIX = "%s_RepsAndLabels.h5"
DEFAULT_MODEL_TYPE = "ViT_SelfSupervised_ImageNet"


class FeatureStore:
    """Read and write per-video feature matrices."""

    def __init__(self, path: str, mode: str = "r"):
        import h5py
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._h5 = h5py.File(path, mode)
        self.path = path

    def write_video(self, video: str, reps: np.ndarray) -> None:
        if video in self._h5:
            del self._h5[video]
        self._h5.create_dataset(video, data=np.asarray(reps))

    def read_video(self, video: str) -> np.ndarray:
        return np.asarray(self._h5[video])

    def videos(self) -> List[str]:
        return list(self._h5.keys())

    def close(self) -> None:
        self._h5.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def rgb_store_path(root: str, model_type: str = DEFAULT_MODEL_TYPE) -> str:
    return os.path.join(root, "results", RGB_SUFFIX % model_type)
