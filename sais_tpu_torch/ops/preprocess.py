"""Frame preprocessing on the device: center-crop, resize, normalize.

Counterpart of `sais_tpu/ops/preprocess.py`.  Reference pipeline
(main_dino.py:300-326, extract_representations.py:145-162): PIL center-crop
to 0.8H x 0.8W, bilinear resize to 224x224, /255, ImageNet mean/std.

The resize is bit-exact with PIL's `Image.resize((r, r), BILINEAR)` on
uint8 images: Pillow resamples in fixed point (triangle filter with
adaptive support, coefficients quantized to 1 << 22, the horizontal pass
rounded and clipped to uint8 before the vertical pass; Resample.c
precompute_coeffs / normalize_coeffs_8bpc / ImagingResampleHorizontal_8bpc).
`resize_pil_exact` replays that integer arithmetic in int32 tensors, one
banded gather per filter tap.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from sais_tpu_torch.config import PreprocessConfig

_PRECISION_BITS = 32 - 8 - 2          # Pillow Resample.c PRECISION_BITS
_HALF = 1 << (_PRECISION_BITS - 1)    # rounding bias of the 8bpc passes


def center_crop_bounds(size: int, frac: float) -> Tuple[int, int]:
    """(start, stop) bounds of torchvision's CenterCrop with a fractional
    size: top = int(round((size - frac*size)/2)), and PIL's crop box rounds
    each coordinate half-to-even, so stop = round(top + crop)."""
    crop = frac * size
    top = int(round((size - crop) / 2.0))
    return top, int(round(top + crop))


@lru_cache(maxsize=64)
def pil_bilinear_coeffs(in_size: int, out_size: int
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Pillow's precompute_coeffs + normalize_coeffs_8bpc for the BILINEAR
    (triangle, support 1) filter along one axis.

    Returns (xmin (out,) int32, coeffs (out, ksize) int32) where
    out[o] = clip8((sum_k in[xmin[o]+k] * coeffs[o, k] + (1 << 21)) >> 22).
    """
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    xmins = np.zeros(out_size, np.int32)
    kk = np.zeros((out_size, ksize), np.int32)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        ss = 1.0 / filterscale
        w = np.zeros(ksize, np.float64)
        for x in range(xmax):
            arg = (x + xmin - center + 0.5) * ss
            w[x] = max(0.0, 1.0 - abs(arg))
        total = w[:xmax].sum()
        if total != 0.0:
            w[:xmax] /= total
        q = np.where(w < 0, (w * (1 << _PRECISION_BITS) - 0.5),
                     (w * (1 << _PRECISION_BITS) + 0.5)).astype(np.int64)
        kk[xx] = q.astype(np.int32)
        xmins[xx] = xmin
    return xmins, kk


def _resample_axis_8bpc(x: torch.Tensor, axis: int, out_size: int
                        ) -> torch.Tensor:
    """One fixed-point resample pass over `axis` of a uint8 tensor, bit-exact
    with ImagingResampleHorizontal_8bpc.  Sums in int32 (at most
    255 * 2**22 plus the bias, below 2**31); returns uint8."""
    in_size = x.shape[axis]
    xmins, kk = pil_bilinear_coeffs(in_size, out_size)
    shape = list(x.shape)
    shape[axis] = out_size
    acc = torch.full(shape, _HALF, dtype=torch.int32, device=x.device)
    base = torch.as_tensor(xmins, dtype=torch.int64, device=x.device)
    wshape = [1] * x.ndim
    wshape[axis] = out_size
    coeffs = torch.as_tensor(kk, device=x.device)
    for k in range(kk.shape[1]):
        idx = (base + k).clamp(0, in_size - 1)
        taps = x.index_select(axis, idx).to(torch.int32)
        acc += taps * coeffs[:, k].reshape(wshape)
    # clip8: >> PRECISION_BITS, clamp to [0, 255]
    return (acc >> _PRECISION_BITS).clamp(0, 255).to(torch.uint8)


def resize_pil_exact(frames_u8: torch.Tensor, out_size: int) -> torch.Tensor:
    """(..., H, W, C) uint8 -> (..., out, out, C) uint8, bit-exact with
    `PIL.Image.resize((out, out), Image.BILINEAR)`: horizontal pass first,
    uint8 between the passes, like ImagingResample."""
    x = _resample_axis_8bpc(frames_u8, frames_u8.ndim - 2, out_size)
    return _resample_axis_8bpc(x, frames_u8.ndim - 3, out_size)


def normalize_batch(frames: torch.Tensor, cfg: PreprocessConfig,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, S, S, 3) uint8 -> (x / 255 - mean) / std in float32, cast to
    `dtype` last."""
    x = frames.to(torch.float32) / 255.0
    mean = torch.tensor(cfg.mean, dtype=torch.float32, device=frames.device)
    std = torch.tensor(cfg.std, dtype=torch.float32, device=frames.device)
    return ((x - mean) / std).to(dtype)


def preprocess_batch(frames: torch.Tensor, cfg: PreprocessConfig,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, H, W, 3) uint8 RGB -> (B, resize, resize, 3) normalized, on the
    frames' device.  Crop and resize reproduce the reference's PIL
    transform stack bit for bit (extract_representations.py:158-162)."""
    _, h, w, _ = frames.shape
    r0, r1 = center_crop_bounds(h, cfg.crop_height_frac)
    c0, c1 = center_crop_bounds(w, cfg.crop_width_frac)
    x = resize_pil_exact(frames[:, r0:r1, c0:c1, :], cfg.resize)
    return normalize_batch(x, cfg, dtype)
