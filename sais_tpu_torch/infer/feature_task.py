"""FeatureExtraction task (the reference's task='FeatureExtraction'): raw
video snippets -> per-snippet encoder features, kept as the
all_info_dict_<encoder> artifact (single_epoch_feature_extraction,
perform_training.py:15-45; fullModel.extractFeatures,
prepare_model.py:150-177; saved by train.py:100-103).

Counterpart of `sais_tpu/infer/feature_task.py`: the encoders run on the
snippets' device (the card unless the caller keeps them on the CPU), and
the pickle keeps the JAX package's keys and leaf types (lists of numpy
arrays and video names).
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch

from sais_tpu_torch.models.r3d import R3D18, r3d18_features
from sais_tpu_torch.models.vit import VisionTransformer, vit_features


def extract_snippet_features_vit(vit: VisionTransformer,
                                 snippets: torch.Tensor) -> np.ndarray:
    """ViT path (prepare_model.py:160-175): (B, S, T, H, W, 3) normalized
    snippets -> (B, S, T, D) per-frame features, every frame through the
    encoder in one batch (the fused K1 path for a bf16 model on the
    card)."""
    b, s, t = snippets.shape[:3]
    flat = snippets.reshape((b * s * t,) + tuple(snippets.shape[3:]))
    with torch.inference_mode():
        feats = vit_features(vit, flat)
    return feats.reshape(b, s, t, -1).cpu().numpy()


def extract_snippet_features_r3d(r3d: R3D18, snippets: torch.Tensor
                                 ) -> np.ndarray:
    """R3D path (prepare_model.py:153-159): (B, S, T, H, W, 3) normalized
    clips -> (B, S, 512) pooled snippet features."""
    b, s = snippets.shape[:2]
    flat = snippets.reshape((b * s,) + tuple(snippets.shape[2:]))
    with torch.inference_mode():
        feats = r3d18_features(r3d, flat)
    return feats.reshape(b, s, -1).cpu().numpy()


def run_feature_extraction(batches: Iterable[Tuple[Sequence[str],
                                                   torch.Tensor,
                                                   np.ndarray]],
                           encoder, encoder_type: str = "ViT"
                           ) -> Dict[str, List]:
    """single_epoch_feature_extraction: iterate (videonames, snippets,
    labels) batches and gather the all_info_dict lists (one array a
    sample under 'snippets' and 'labels')."""
    out: Dict[str, List] = {"snippets": [], "videonames": [], "labels": []}
    for videonames, snippets, labels in batches:
        snippets = torch.as_tensor(snippets)
        feats = (extract_snippet_features_vit(encoder, snippets)
                 if encoder_type == "ViT"
                 else extract_snippet_features_r3d(encoder, snippets))
        out["snippets"].extend(feats)
        out["videonames"].extend(videonames)
        out["labels"].extend(np.asarray(labels))
    return out


def save_all_info_dict(savepath: str, info: Dict[str, List],
                       encoder_type: str) -> str:
    """<savepath>/all_info_dict_<encoder>.pkl (train.py:100-103)."""
    os.makedirs(savepath, exist_ok=True)
    dest = os.path.join(savepath, f"all_info_dict_{encoder_type}.pkl")
    with open(dest, "wb") as f:
        pickle.dump(info, f)
    return dest
