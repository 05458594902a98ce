"""Video-like frames drawn from the seed on the device: per frame and
channel a random level, plus octaves of bilinearly upsampled uniform
noise (the first on a `grid` of cells, each next on a grid twice as fine
at half the amplitude), stretched to 0-255 per frame.  Frames differ from
each other as video frames do, so that a model's outputs for two frames
differ too; crops of uniform pixel noise all look alike to a ViT."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def draw(gen: torch.Generator, n: int, height: int, width: int,
         grid: Sequence[int], octaves: int) -> torch.Tensor:
    """(n, height, width, 3) uint8 on the generator's device."""
    dev = gen.device
    x = torch.rand((n, 3, 1, 1), generator=gen, device=dev)
    gh, gw = grid
    for o in range(octaves):
        low = torch.rand((n, 3, gh << o, gw << o), generator=gen,
                         device=dev) - 0.5
        x = x + 0.5 ** o * F.interpolate(low, size=(height, width),
                                          mode="bilinear",
                                          align_corners=False)
    lo = x.amin((1, 2, 3), keepdim=True)
    x = (x - lo) / (x.amax((1, 2, 3), keepdim=True) - lo)
    return (x * 255).round().to(torch.uint8).permute(0, 2, 3, 1) \
        .contiguous()
