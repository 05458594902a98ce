"""Attention-overlay video (reference: dino-main/video_generation.py;
counterpart of `sais_tpu/eval/video_generation.py`).

The reference explodes a video with ffmpeg, runs get_last_selfattention
per frame, saves per-head heatmap PNGs and re-encodes with ffmpeg
(video_generation.py:48-242).  Here the loop streams: frames decode on
the host, the head-averaged CLS attention of a batch is computed on the
model's device, and OpenCV writes the overlay mp4 directly.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sais_tpu_torch.config import PreprocessConfig
from sais_tpu_torch.eval.attention_viz import (cls_attention_maps,
                                               threshold_masks, upsample_maps)
from sais_tpu_torch.models.vit import VisionTransformer
from sais_tpu_torch.ops.preprocess import center_crop_bounds, preprocess_batch


def attention_video(model: VisionTransformer, video_path: str, out_path: str,
                    pre: PreprocessConfig = PreprocessConfig(),
                    batch_size: int = 32, alpha: float = 0.5,
                    fps: Optional[float] = None,
                    threshold: Optional[float] = None) -> int:
    """Write <video> with the DINO CLS attention blended on top; returns
    the number of frames written.  The float32 model runs on its own
    device.  threshold: keep only the attention inside the mass-threshold
    masks (visualize_attention.py --threshold)."""
    import cv2
    from sais_tpu_torch.io.video import VideoReader

    device = model.cls_token.device
    patch = model.cfg.patch_size
    n_written = 0
    writer = None
    with VideoReader(video_path) as r:
        out_fps = fps or r.fps or 30.0
        for batch in r.batches(batch_size):
            x = preprocess_batch(torch.from_numpy(batch).to(device), pre,
                                 torch.float32)
            maps = cls_attention_maps(model, x)
            heat = upsample_maps(maps.mean(axis=1), patch)
            if threshold is not None:
                keep = upsample_maps(threshold_masks(maps, threshold).sum(
                    1).astype(np.float32), patch)
                heat = heat * (keep > 0)
            for i, frame in enumerate(batch):
                h = heat[i]
                h = (h - h.min()) / max(h.max() - h.min(), 1e-8)
                hm = cv2.applyColorMap((h * 255).astype(np.uint8),
                                       cv2.COLORMAP_INFERNO)[:, :, ::-1]
                # the map covers the centre crop the ViT saw: crop the
                # base frame the same way before resizing it
                r0, r1 = center_crop_bounds(frame.shape[0],
                                            pre.crop_height_frac)
                c0, c1 = center_crop_bounds(frame.shape[1],
                                            pre.crop_width_frac)
                base = cv2.resize(frame[r0:r1, c0:c1],
                                  (h.shape[1], h.shape[0]))
                blend = ((1 - alpha) * base + alpha * hm).astype(np.uint8)
                if writer is None:
                    writer = cv2.VideoWriter(
                        out_path, cv2.VideoWriter_fourcc(*"mp4v"), out_fps,
                        (blend.shape[1], blend.shape[0]))
                writer.write(blend[:, :, ::-1])
                n_written += 1
    if writer is not None:
        writer.release()
    return n_written
