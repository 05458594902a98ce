"""R3D-18 video encoder (torchvision's r3d_18 without its classifier).

Counterpart of `sais_tpu/models/r3d.py`.  The reference's raw-video path
encodes 16-frame snippets with torchvision's r3d_18, its fc stripped, into
512-wide snippet features (prepare_model.py:35-37), on clips normalized
with Kinetics statistics (prepare_dataset.py:2746-2747).  Architecture: a
(3, 7, 7) stem convolution (stride 1, 2, 2), four stages of two
BasicBlocks at 64 / 128 / 256 / 512 channels with stride 2 in every
dimension from the second stage on, BatchNorm + ReLU, then the mean over
T, H and W.

The BatchNorms are frozen and folded as in the JAX package's `_bn`:
x * (w / sqrt(rv + eps)) + (b - rm * w / sqrt(rv + eps)), with all four
of w, b, rm and rv parameters, so that an unfrozen encoder trains them as
the JAX package's SGD does.  The convolutions run on cuDNN in float32
with TF32 off.  Clips come channels-last, (B, T, H, W, 3), as the JAX
package takes them.
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterator, Mapping

import torch
import torch.nn as nn
import torch.nn.functional as F

KINETICS_MEAN = (0.43216, 0.394666, 0.37645)
KINETICS_STD = (0.22803, 0.22145, 0.216989)
STAGE_CHANNELS = ((64, 64), (64, 128), (128, 256), (256, 512))


class Conv3d(nn.Module):
    """A bias-free Conv3d weight (out, in, kd, kh, kw), padded to keep
    size at stride 1 (k // 2 a side)."""

    def __init__(self, cin: int, cout: int, kd: int, kh: int, kw: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(cout, cin, kd, kh, kw))

    def forward(self, x: torch.Tensor, stride) -> torch.Tensor:
        pad = tuple(k // 2 for k in self.w.shape[2:])
        return F.conv3d(x, self.w, stride=stride, padding=pad)


class FrozenBN(nn.Module):
    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.w = nn.Parameter(torch.ones(c))
        self.b = nn.Parameter(torch.zeros(c))
        self.rm = nn.Parameter(torch.zeros(c))
        self.rv = nn.Parameter(torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.rv + self.eps)
        scale = (self.w * inv).reshape(1, -1, 1, 1, 1)
        bias = (self.b - self.rm * self.w * inv).reshape(1, -1, 1, 1, 1)
        return x * scale + bias


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, down: bool):
        super().__init__()
        self.conv1, self.bn1 = Conv3d(cin, cout, 3, 3, 3), FrozenBN(cout)
        self.conv2, self.bn2 = Conv3d(cout, cout, 3, 3, 3), FrozenBN(cout)
        self.down = Conv3d(cin, cout, 1, 1, 1) if down else None
        self.down_bn = FrozenBN(cout) if down else None

    def forward(self, x: torch.Tensor, stride) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x, stride)))
        y = self.bn2(self.conv2(y, 1))
        if self.down is not None:
            x = self.down_bn(self.down(x, stride))
        return F.relu(x + y)


class R3D18(nn.Module):
    def __init__(self):
        super().__init__()
        self.stem, self.stem_bn = Conv3d(3, 64, 3, 7, 7), FrozenBN(64)
        self.layers = nn.ModuleList(
            nn.ModuleList([BasicBlock(cin, cout, si > 0),
                           BasicBlock(cout, cout, False)])
            for si, (cin, cout) in enumerate(STAGE_CHANNELS))


@contextlib.contextmanager
def no_tf32() -> Iterator[None]:
    """cuDNN convolutions at float32 precision for the block (TF32 is
    cuDNN's default for convolutions)."""
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old


def r3d18_features(model: R3D18, clips: torch.Tensor) -> torch.Tensor:
    """clips: (B, T, H, W, 3) normalized -> (B, 512) float32 pooled
    features (torchvision r3d_18 minus fc, prepare_model.py:36-37)."""
    x = clips.float().permute(0, 4, 1, 2, 3)
    with no_tf32():
        x = F.relu(model.stem_bn(model.stem(x, (1, 2, 2))))
        for si, stage in enumerate(model.layers):
            x = stage[0](x, 1 if si == 0 else 2)
            x = stage[1](x, 1)
    return x.mean(dim=(2, 3, 4))


def r3d18_init(generator: torch.Generator) -> R3D18:
    """Random weights on the CPU with torchvision's shapes: normal *
    sqrt(2 / fan_in) convolutions, BatchNorms at w 1, b 0, rm 0, rv 1."""
    model = R3D18()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".w") and p.dim() == 5:
                fan = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=generator)
                        * (2.0 / fan) ** 0.5)
    return model


def r3d18_state_from_reference(sd: Mapping[str, Any]) -> dict:
    """torchvision r3d_18 state_dict (stem.0 / 1, layerX.Y.conv{1,2}.{0,1},
    layerX.0.downsample.{0,1}; fc ignored) -> R3D18 state_dict."""

    def t(k):
        return torch.as_tensor(sd[k]).detach().float()

    out = {"stem.w": t("stem.0.weight")}

    def bn(dst, src):
        for a, b in (("w", "weight"), ("b", "bias"), ("rm", "running_mean"),
                     ("rv", "running_var")):
            out[f"{dst}.{a}"] = t(f"{src}.{b}")

    bn("stem_bn", "stem.1")
    for li in range(4):
        for bi in range(2):
            p, q = f"layers.{li}.{bi}", f"layer{li + 1}.{bi}"
            out[p + ".conv1.w"] = t(q + ".conv1.0.weight")
            bn(p + ".bn1", q + ".conv1.1")
            out[p + ".conv2.w"] = t(q + ".conv2.0.weight")
            bn(p + ".bn2", q + ".conv2.1")
            if q + ".downsample.0.weight" in sd:
                out[p + ".down.w"] = t(q + ".downsample.0.weight")
                bn(p + ".down_bn", q + ".downsample.1")
    return out


def normalize_clips(clips_u8: torch.Tensor) -> torch.Tensor:
    """uint8 (B, T, H, W, 3) -> Kinetics-normalized float32
    (normalizeSnippets, prepare_dataset.py:2746-2752)."""
    x = clips_u8.float() / 255.0
    mean = torch.tensor(KINETICS_MEAN, device=x.device)
    std = torch.tensor(KINETICS_STD, device=x.device)
    return (x - mean) / std
