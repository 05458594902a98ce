"""DINO multi-crop augmentation on the device.

Counterpart of `sais_tpu/ops/augment.py`, the batched rebuild of
DataAugmentationDINO (dino-main/main_dino.py:637-682): random resized
crops (area scale + log-uniform aspect jitter, a static box prefilter then
a bilinear gather), horizontal flip, color jitter (brightness 0.4,
contrast 0.4, saturation 0.2, hue 0.1, p = 0.8, a clamp after each op and
the four ops in a random order per crop), random grayscale (p = 0.2),
Gaussian blur (sigma ~ U[0.1, 2]), solarization (p = 0.2 on the second
global crop) and ImageNet normalization.

Every random op is split in two: `draw_crop_params` draws a crop's
parameters for the whole batch from an explicit torch.Generator (on the
generator's device), and the deterministic halves (`random_resized_crop`,
`color_jitter`, `rgb_to_gray`, `gaussian_blur`, `solarize`,
`apply_crop`) apply them to (B, H, W, 3) float images in [0, 1] with one
value per image.  Torch and JAX random streams differ, so parity with the
JAX package is held on the apply halves fed the same parameters.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional, Tuple

import torch

from sais_tpu_torch.ops.preprocess import center_crop_bounds
from sais_tpu_torch.utils import profiling

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class CropSpec:
    size: int
    scale: Tuple[float, float]
    blur_p: float
    solarize_p: float = 0.0


GLOBAL_1 = CropSpec(224, (0.4, 1.0), blur_p=1.0)
GLOBAL_2 = CropSpec(224, (0.4, 1.0), blur_p=0.1, solarize_p=0.2)
LOCAL = CropSpec(96, (0.05, 0.4), blur_p=0.5)

# torchvision ColorJitter's random op order: one of the 24 permutations of
# (brightness, contrast, saturation, hue), in itertools order
PERMUTATIONS = tuple(itertools.permutations(range(4)))


@dataclasses.dataclass
class CropParams:
    """One crop's random parameters, a (B,) tensor each."""

    area: torch.Tensor          # crop area as a fraction, U[scale)
    log_ratio: torch.Tensor     # U[log 3/4, log 4/3)
    ux: torch.Tensor            # crop offset fractions, U[0, 1)
    uy: torch.Tensor
    flip: torch.Tensor          # bool
    jitter: torch.Tensor        # bool
    brightness: torch.Tensor    # U[0.6, 1.4)
    contrast: torch.Tensor      # U[0.6, 1.4)
    saturation: torch.Tensor    # U[0.8, 1.2)
    hue: torch.Tensor           # U[-0.1, 0.1) turns
    perm: torch.Tensor          # int64 index into PERMUTATIONS
    gray: torch.Tensor          # bool
    blur: torch.Tensor          # bool
    sigma: torch.Tensor         # U[0.1, 2)
    solarize: torch.Tensor      # bool


def draw_crop_params(generator: torch.Generator, b: int,
                     spec: CropSpec) -> CropParams:
    """Draw one crop's parameters for b images."""
    dev = generator.device

    def u(lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand((b,), generator=generator,
                                           device=dev)

    def bern(p):
        return torch.rand((b,), generator=generator, device=dev) < p

    return CropParams(
        area=u(*spec.scale), log_ratio=u(math.log(3 / 4), math.log(4 / 3)),
        ux=u(), uy=u(), flip=bern(0.5), jitter=bern(0.8),
        brightness=u(0.6, 1.4), contrast=u(0.6, 1.4), saturation=u(0.8, 1.2),
        hue=u(-0.1, 0.1),
        perm=torch.randint(0, len(PERMUTATIONS), (b,), generator=generator,
                           device=dev),
        gray=bern(0.2), blur=bern(spec.blur_p), sigma=u(0.1, 2.0),
        solarize=bern(spec.solarize_p))


def _per_image(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A (B,) value broadcast against (B, H, W, C) images."""
    return v.to(x.device).reshape(-1, 1, 1, 1)


def prefilter_factor(h: int, w: int, out_size: int,
                     scale: Tuple[float, float]) -> int:
    """Static box-downsampling factor that keeps the worst-case crop to
    output downscale at or below ~2x (each crop dimension is at most
    sqrt(h w scale_max 4/3), clamped to the image)."""
    worst = min((h * w * float(scale[1]) * (4.0 / 3.0)) ** 0.5,
                float(max(h, w))) / (2.0 * out_size)
    return max(1, math.ceil(worst))


def random_resized_crop(images: torch.Tensor, area: torch.Tensor,
                        log_ratio: torch.Tensor, ux: torch.Tensor,
                        uy: torch.Tensor, out_size: int,
                        scale: Tuple[float, float]) -> torch.Tensor:
    """(B, H, W, C) -> (B, out, out, C): box prefilter by a static factor,
    then each image's crop (area fraction, aspect exp(log_ratio), offsets
    ux, uy) sampled on an out x out grid by a bilinear gather (JAX
    `_random_resized_crop`)."""
    b, h, w, c = images.shape
    f = prefilter_factor(h, w, out_size, scale)
    if f > 1:
        hh, ww = (h // f) * f, (w // f) * f
        images = images[:, :hh, :ww].reshape(b, hh // f, f, ww // f, f,
                                              c).mean((2, 4))
        h, w = hh // f, ww // f
    dev = images.device
    area = h * w * area.to(dev)
    ratio = torch.exp(log_ratio.to(dev))
    cw = torch.clamp(torch.sqrt(area * ratio), 8.0, float(w))
    ch = torch.clamp(torch.sqrt(area / ratio), 8.0, float(h))
    x0 = ux.to(dev) * (w - cw)
    y0 = uy.to(dev) * (h - ch)
    grid = torch.arange(out_size, device=dev, dtype=torch.float32) + 0.5
    ys = y0[:, None] + grid * (ch / out_size)[:, None] - 0.5
    xs = x0[:, None] + grid * (cw / out_size)[:, None] - 0.5
    y0i = torch.clamp(torch.floor(ys), 0, h - 1).long()
    x0i = torch.clamp(torch.floor(xs), 0, w - 1).long()
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    x1i = torch.clamp(x0i + 1, 0, w - 1)
    wy = torch.clamp(ys - y0i, 0.0, 1.0)[:, :, None, None]
    wx = torch.clamp(xs - x0i, 0.0, 1.0)[:, None, :, None]
    bi = torch.arange(b, device=dev)[:, None, None]

    def at(yi, xi):
        return images[bi, yi[:, :, None], xi[:, None, :]]

    return ((1 - wy) * ((1 - wx) * at(y0i, x0i) + wx * at(y0i, x1i))
            + wy * ((1 - wx) * at(y1i, x0i) + wx * at(y1i, x1i)))


def rgb_to_gray(x: torch.Tensor) -> torch.Tensor:
    w = torch.tensor([0.299, 0.587, 0.114], dtype=x.dtype, device=x.device)
    return (x * w).sum(-1, keepdim=True).expand(x.shape)


_T_YIQ = ((0.299, 0.587, 0.114), (0.596, -0.274, -0.322),
          (0.211, -0.523, 0.312))
_T_RGB = ((1.0, 0.956, 0.621), (1.0, -0.272, -0.647), (1.0, -1.106, 1.703))


def adjust_hue(x: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Approximate hue rotation in YIQ space, delta in turns per image."""
    theta = _per_image(delta, x) * 2 * math.pi
    cos, sin = torch.cos(theta), torch.sin(theta)
    t_yiq = torch.tensor(_T_YIQ, dtype=x.dtype, device=x.device)
    t_rgb = torch.tensor(_T_RGB, dtype=x.dtype, device=x.device)
    yiq = x @ t_yiq.T
    i = yiq[..., 1:2] * cos - yiq[..., 2:3] * sin
    q = yiq[..., 1:2] * sin + yiq[..., 2:3] * cos
    return torch.cat([yiq[..., 0:1], i, q], -1) @ t_rgb.T


def color_jitter(x: torch.Tensor, brightness: torch.Tensor,
                 contrast: torch.Tensor, saturation: torch.Tensor,
                 hue: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """The four ColorJitter ops in each image's order PERMUTATIONS[perm],
    each followed by a clamp to [0, 1] (JAX `_color_jitter`)."""

    def op(k, x):
        if k == 0:
            return torch.clamp(x * _per_image(brightness, x), 0.0, 1.0)
        if k == 1:
            mean = rgb_to_gray(x).mean((-3, -2, -1), keepdim=True)
            return torch.clamp((x - mean) * _per_image(contrast, x) + mean,
                               0.0, 1.0)
        if k == 2:
            gray = rgb_to_gray(x)
            return torch.clamp((x - gray) * _per_image(saturation, x) + gray,
                               0.0, 1.0)
        return torch.clamp(adjust_hue(x, hue), 0.0, 1.0)

    order = torch.tensor(PERMUTATIONS, device=x.device)[perm.to(x.device)]
    for pos in range(4):
        sel = order[:, pos].reshape(-1, 1, 1, 1)
        y = x
        for k in range(4):
            y = torch.where(sel == k, op(k, x), y)
        x = y
    return x


def gaussian_blur(x: torch.Tensor, sigma: torch.Tensor,
                  radius: int = 4) -> torch.Tensor:
    """Separable Gaussian blur (9 taps, edge padding) with one sigma per
    image (JAX `_gaussian_blur`)."""
    t = torch.arange(-radius, radius + 1, dtype=x.dtype, device=x.device)
    k = torch.exp(-0.5 * (t / sigma.to(x.device)[:, None]) ** 2)
    k = k / k.sum(-1, keepdim=True)                       # (B, 2r + 1)
    taps = 2 * radius + 1
    h, w = x.shape[1], x.shape[2]
    # edge padding along H, then the vertical pass
    xp = torch.cat([x[:, :1].expand(-1, radius, -1, -1), x,
                    x[:, -1:].expand(-1, radius, -1, -1)], 1)
    x = sum(k[:, i].reshape(-1, 1, 1, 1) * xp[:, i:i + h]
            for i in range(taps))
    xp = torch.cat([x[:, :, :1].expand(-1, -1, radius, -1), x,
                    x[:, :, -1:].expand(-1, -1, radius, -1)], 2)
    return sum(k[:, i].reshape(-1, 1, 1, 1) * xp[:, :, i:i + w]
               for i in range(taps))


def solarize(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0.5, 1.0 - x, x)


def normalize(x: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def apply_crop(images: torch.Tensor, p: CropParams,
               spec: CropSpec) -> torch.Tensor:
    """One augmented, normalized crop of every image (JAX `augment_crop`
    with its draws given): (B, H, W, 3) in [0, 1] -> (B, s, s, 3)."""

    def where(flag, a, b):
        return torch.where(_per_image(flag, b), a, b)

    x = random_resized_crop(images, p.area, p.log_ratio, p.ux, p.uy,
                            spec.size, spec.scale)
    x = where(p.flip, x.flip(2), x)
    x = where(p.jitter, color_jitter(x, p.brightness, p.contrast,
                                     p.saturation, p.hue, p.perm), x)
    x = where(p.gray, rgb_to_gray(x), x)
    x = where(p.blur, gaussian_blur(x, p.sigma), x)
    if spec.solarize_p > 0:
        x = where(p.solarize, solarize(x), x)
    return normalize(x)


def augment_crop(generator: torch.Generator, images: torch.Tensor,
                 spec: CropSpec) -> torch.Tensor:
    """One augmented crop of every image, parameters drawn per image."""
    return apply_crop(images, draw_crop_params(generator, images.shape[0],
                                               spec), spec)


@profiling.spanned("sais.dino.crops")
def multi_crop_batch(generator: torch.Generator, images: torch.Tensor,
                     n_global: int = 2, n_local: int = 8,
                     global_size: int = 224, local_size: int = 96
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(B, H, W, 3) float [0, 1] -> globals (n_global*B, gs, gs, 3) and
    locals (n_local*B, ls, ls, 3) or None, IMAGE-major rows ([img0 crop0,
    img0 crop1, ...]), the layout DINOTrainer.forward regroups."""
    b = images.shape[0]
    gspecs = [GLOBAL_1] + [GLOBAL_2] * (n_global - 1)
    gspecs = [dataclasses.replace(sp, size=global_size) for sp in gspecs]
    globals_ = torch.stack([augment_crop(generator, images, sp)
                            for sp in gspecs], 1)
    globals_ = globals_.reshape(n_global * b, global_size, global_size, 3)
    if not n_local:
        return globals_, None
    spec = dataclasses.replace(LOCAL, size=local_size)
    locals_ = torch.stack([augment_crop(generator, images, spec)
                           for _ in range(n_local)], 1)
    return globals_, locals_.reshape(n_local * b, local_size, local_size, 3)


def center_border_crop(frames, height_frac: float = 0.8,
                       width_frac: float = 0.8, trim_right_px: int = 0):
    """SurgDataset border removal before augmentation (main_dino.py:300-326):
    CenterCrop((height_frac H, width_frac W)), 0.8 / 0.8 by default and
    0.8 / 0.7 for the Gronau videos, then trim_right_px columns off the
    right (the VUA timer overlay, 130 px).  (B, H, W, C) numpy arrays or
    tensors."""
    h, w = frames.shape[1], frames.shape[2]
    top, bottom = center_crop_bounds(h, height_frac)
    left, right = center_crop_bounds(w, width_frac)
    out = frames[:, top:bottom, left:right]
    if trim_right_px:
        out = out[:, :, :max(out.shape[2] - trim_right_px, 1)]
    return out
