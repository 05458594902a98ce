"""Optical flow -> RGB rendering (the flowpy algorithm that ptlflow
vendors), as the reference renders RAFT flow for DINO
(extract_representations.py:243-247).

Own copy of `sais_tpu/ops/flow_viz.py`: a 55-entry Middlebury colour wheel
(R-Y-G-C-B-M-R in 15/6/4/11/13/6 steps), hue from the flow angle
interpolated between wheel entries, saturation from the radius over the
image's own maximum, white at zero motion ('bright'), and the reference's
truncating uint8 conversion.  `flow_to_rgb` / `flow_to_rgb_uint8` render
one image on the host in float64 numpy; `flow_to_rgb_device` renders a
batch where the flow lies (the card on the fused flow path), in float32.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

DEFAULT_TRANSITIONS = (15, 6, 4, 11, 13, 6)


def make_colorwheel(transitions=DEFAULT_TRANSITIONS) -> np.ndarray:
    """(sum(transitions), 3) float wheel through R-Y-G-C-B-M-R."""
    hues = np.array([
        [255, 0, 0], [255, 255, 0], [0, 255, 0],
        [0, 255, 255], [0, 0, 255], [255, 0, 255], [255, 0, 0],
    ], dtype=np.float64)
    wheel = np.zeros((sum(transitions), 3))
    col = 0
    for i, t in enumerate(transitions):
        for j in range(t):
            wheel[col] = hues[i] + (hues[i + 1] - hues[i]) * (j / t)
            col += 1
    return wheel


_WHEEL = make_colorwheel()


def flow_to_rgb(flow: np.ndarray, flow_max_radius: Optional[float] = None,
                background: str = "bright") -> np.ndarray:
    """(H, W, 2) flow (u, v) -> (H, W, 3) float RGB in [0, 1].

    angle = arg(u + i v) mapped onto the wheel with (ncols - 1) / (2 pi)
    scaling; 'bright' renders 1 - r (1 - hue), and radii above 1 (an
    explicit flow_max_radius below the image's maximum) fall back to
    hue / r.  Non-finite vectors render black ('bright') or white."""
    u = flow[..., 0].astype(np.float64)
    v = flow[..., 1].astype(np.float64)
    nan_mask = ~np.isfinite(u) | ~np.isfinite(v)
    u = np.where(nan_mask, 0.0, u)
    v = np.where(nan_mask, 0.0, v)
    radius = np.sqrt(u * u + v * v)
    angle = np.arctan2(v, u)
    if flow_max_radius is None:
        flow_max_radius = float(np.max(radius)) if radius.size else 1.0
    if flow_max_radius > 0:
        radius = radius / flow_max_radius
    ncols = len(_WHEEL)
    angle = np.where(angle < 0, angle + 2 * np.pi, angle)
    angle = angle * ((ncols - 1) / (2 * np.pi))
    frac, floor = np.modf(angle)
    ceil = np.ceil(angle).astype(int) % ncols
    hue = (_WHEEL[floor.astype(int)] * (1 - frac[..., None]) +
           _WHEEL[ceil] * frac[..., None])
    r = radius[..., None]
    if background == "bright":
        colors = 255.0 - r * (255.0 - hue)
        over = radius > 1
        colors[over] = hue[over] / r[over]
        colors[nan_mask] = 0.0
    else:
        colors = r * hue
        over = radius > 1
        colors[over] = 255.0 - (1.0 / r[over]) * (255.0 - hue[over])
        colors[nan_mask] = 255.0
    return (colors / 255.0).astype(np.float32)


def flow_to_rgb_uint8(flow: np.ndarray, **kw) -> np.ndarray:
    """The reference's uint8 convention: truncation of rgb * 255
    (extract_representations.py:247)."""
    return (flow_to_rgb(flow, **kw) * 255.0).astype(np.uint8)


def flow_to_rgb_device(flow: torch.Tensor,
                       background: str = "bright") -> torch.Tensor:
    """Batched twin of `flow_to_rgb_uint8` on flow's device: (B, H, W, 2)
    -> (B, H, W, 3) uint8, each image normalized by its own maximum
    radius.  float32 where the host renders in float64, so a colour can
    land one level off at the truncation boundary."""
    wheel = torch.as_tensor(_WHEEL, dtype=torch.float32, device=flow.device)
    ncols = wheel.shape[0]
    u = flow[..., 0].float()
    v = flow[..., 1].float()
    finite = torch.isfinite(u) & torch.isfinite(v)
    u = torch.where(finite, u, 0.0)
    v = torch.where(finite, v, 0.0)
    radius = torch.sqrt(u * u + v * v)
    max_r = radius.amax(dim=(1, 2), keepdim=True)
    radius = radius / torch.where(max_r > 0, max_r, 1.0)
    angle = torch.atan2(v, u)
    angle = torch.where(angle < 0, angle + 2 * np.pi, angle)
    angle = angle * ((ncols - 1) / (2 * np.pi))
    floor = angle.floor()
    frac = (angle - floor)[..., None]
    hue = (wheel[floor.long()] * (1.0 - frac)
           + wheel[angle.ceil().long() % ncols] * frac)
    r = radius[..., None]
    over = r > 1
    if background == "bright":
        colors = 255.0 - r * (255.0 - hue)
        colors = torch.where(over, hue / r.clamp_min(1e-12), colors)
        colors = torch.where(finite[..., None], colors, 0.0)
    else:
        colors = r * hue
        colors = torch.where(over, 255.0 - (255.0 - hue) / r.clamp_min(1e-12),
                             colors)
        colors = torch.where(finite[..., None], colors, 255.0)
    return colors.clamp(0.0, 255.0).to(torch.uint8)
