"""Attention-map visualization (reference: dino-main/visualize_attention.py;
counterpart of `sais_tpu/eval/attention_viz.py`).

Per-head CLS-attention heatmaps at image resolution and the
mass-thresholded binary masks the reference renders: sort the attention
descending and keep the smallest set of patches holding `threshold` of
the mass (visualize_attention.py:179-213).  The attention comes from the
float32 ViT on the model's device; the maps are numpy on the host.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from sais_tpu_torch.models.vit import VisionTransformer, vit_forward


def cls_attention_maps(model: VisionTransformer, images: torch.Tensor
                       ) -> np.ndarray:
    """(B, H, W, 3) normalized -> (B, heads, gh, gw) float32 CLS-to-patch
    attention of the last block (get_last_selfattention)."""
    with torch.inference_mode():
        _, attn = vit_forward(model, images, return_last_attention=True)
    cls_attn = attn[:, :, 0, 1:]     # the CLS row without the CLS column
    b, h, _ = cls_attn.shape
    gh = images.shape[1] // model.cfg.patch_size
    gw = images.shape[2] // model.cfg.patch_size
    return cls_attn.reshape(b, h, gh, gw).float().cpu().numpy()


def upsample_maps(maps: np.ndarray, patch_size: int) -> np.ndarray:
    """Nearest-neighbour upsampling of patch-grid maps to pixels (the
    reference: nn.functional.interpolate, scale_factor=patch)."""
    return maps.repeat(patch_size, axis=-2).repeat(patch_size, axis=-1)


def threshold_masks(maps: np.ndarray, threshold: float = 0.6) -> np.ndarray:
    """Per head, the top patches holding `threshold` of the attention mass
    (visualize_attention.py:188-199): (B, heads, gh, gw) -> bool masks of
    the same shape."""
    b, h, gh, gw = maps.shape
    flat = maps.reshape(b, h, gh * gw)
    val = flat / flat.sum(axis=-1, keepdims=True)
    order = np.argsort(val, axis=-1)               # ascending
    cum = np.cumsum(np.take_along_axis(val, order, -1), axis=-1)
    keep_sorted = cum > (1 - threshold)
    keep = np.zeros_like(keep_sorted)
    np.put_along_axis(keep, order, keep_sorted, axis=-1)
    return keep.reshape(b, h, gh, gw)


def save_attention_pngs(maps: np.ndarray, out_prefix: str,
                        patch_size: int = 16) -> List[str]:
    """One grayscale PNG per image and head, min-max scaled; returns the
    paths (<prefix>_img<b>_head<h>.png)."""
    from PIL import Image
    up = upsample_maps(maps, patch_size)
    paths = []
    for b in range(up.shape[0]):
        for h in range(up.shape[1]):
            m = up[b, h]
            m = 255 * (m - m.min()) / max(m.max() - m.min(), 1e-9)
            path = f"{out_prefix}_img{b}_head{h}.png"
            Image.fromarray(m.astype(np.uint8)).save(path)
            paths.append(path)
    return paths
