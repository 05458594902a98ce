"""RAFT optical flow (Teed & Deng, ECCV 2020), the 'things' architecture.

Counterpart of `sais_tpu/models/raft.py`.  The modules carry the
reference's own names (fnet.*, cnet.*, update_block.*), so a princeton-vl /
ptlflow state_dict loads through `port.weights.raft_state_from_reference`.
The JAX module's TPU layout choices (space-to-depth stem, batch norm folded
into the convolutions, a lanes-major pyramid with a static-shift lookup,
lax.scan) are not copied: the port computes the same function with
`F.conv2d` at symmetric k//2 padding, a query-major pyramid, a gather
lookup and a Python loop over the iterations.

Dtypes follow the JAX package's `FlowExtractor` split: the feature and
context encoders run in `compute_dtype` (bf16 on the pipeline's default),
the feature maps are cast to float32 before the correlation, the GRU state
and context are float32, so the update loop runs in float32, and the
pyramid is stored in `RAFTConfig.corr_dtype`.  (A float64 compute_dtype,
with a float64 model, keeps everything in float64: the reference the card
checks are held to.)  Every float32 convolution and product here runs at
full float32 precision: `raft_forward` turns TF32 off for its duration
(PyTorch lets cuDNN take TF32 by default), as the JAX package computes
them at 'highest'.  The update loop's convolutions run without cuDNN
(`without_cudnn`).
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from sais_tpu_torch.config import RAFTConfig


def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """The conv in x's dtype (the bf16 encoders keep float32 weights)."""
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv2d(x, conv.weight.to(x.dtype), bias, conv.stride,
                    conv.padding)


class InstanceNorm(nn.Module):
    """nn.InstanceNorm2d's default (affine=False, per-sample statistics),
    with the statistics in float32 (or wider) and the result in x's
    dtype."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        var, mean = torch.var_mean(x32, dim=(2, 3), unbiased=False,
                                   keepdim=True)
        return ((x32 - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)


class FrozenBatchNorm2d(nn.Module):
    """Eval-mode BatchNorm2d: nn.BatchNorm2d's state_dict names without
    num_batches_tracked; scale and shift in float32, applied in x's
    dtype."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        for name, value in (("weight", 1.0), ("bias", 0.0),
                            ("running_mean", 0.0), ("running_var", 1.0)):
            self.register_buffer(name, torch.full((channels,), value))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        return (x * scale.to(x.dtype)[:, None, None]
                + shift.to(x.dtype)[:, None, None])


_NORMS = {"instance": InstanceNorm, "batch": FrozenBatchNorm2d}


class ResidualBlock(nn.Module):
    def __init__(self, cin: int, cout: int, norm: str, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1, stride=stride)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.norm1 = _NORMS[norm](cout)
        self.norm2 = _NORMS[norm](cout)
        # the reference also registers downsample.1 as norm3;
        # raft_state_from_reference takes either name
        self.downsample = (None if stride == 1 else nn.Sequential(
            nn.Conv2d(cin, cout, 1, stride=stride), _NORMS[norm](cout)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(_conv(self.conv1, x)))
        y = F.relu(self.norm2(_conv(self.conv2, y)))
        if self.downsample is not None:
            x = self.downsample[1](_conv(self.downsample[0], x))
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """7x7/2 stem and three residual stages to 1/8 resolution, then a 1x1
    projection: (B, 3, H, W) in [-1, 1] -> (B, out_dim, H/8, W/8)."""

    def __init__(self, out_dim: int, norm: str):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3)
        self.norm1 = _NORMS[norm](64)
        for i, (cin, cout, stride) in enumerate(
                ((64, 64, 1), (64, 96, 2), (96, 128, 2)), start=1):
            setattr(self, f"layer{i}", nn.Sequential(
                ResidualBlock(cin, cout, norm, stride),
                ResidualBlock(cout, cout, norm, 1)))
        self.conv2 = nn.Conv2d(128, out_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.norm1(_conv(self.conv1, x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return _conv(self.conv2, x)


class BasicMotionEncoder(nn.Module):
    def __init__(self, cfg: RAFTConfig):
        super().__init__()
        planes = cfg.corr_levels * (2 * cfg.corr_radius + 1) ** 2
        self.convc1 = nn.Conv2d(planes, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(64 + 192, 128 - 2, 3, padding=1)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        c = F.relu(self.convc2(F.relu(self.convc1(corr))))
        f = F.relu(self.convf2(F.relu(self.convf1(flow))))
        return torch.cat([F.relu(self.conv(torch.cat([c, f], 1))), flow], 1)


class SepConvGRU(nn.Module):
    """Two GRUs in turn, over (1, 5) then (5, 1) convolutions."""

    def __init__(self, hidden: int, input_dim: int):
        super().__init__()
        cin = hidden + input_dim
        self.convz1 = nn.Conv2d(cin, hidden, (1, 5), padding=(0, 2))
        self.convr1 = nn.Conv2d(cin, hidden, (1, 5), padding=(0, 2))
        self.convq1 = nn.Conv2d(cin, hidden, (1, 5), padding=(0, 2))
        self.convz2 = nn.Conv2d(cin, hidden, (5, 1), padding=(2, 0))
        self.convr2 = nn.Conv2d(cin, hidden, (5, 1), padding=(2, 0))
        self.convq2 = nn.Conv2d(cin, hidden, (5, 1), padding=(2, 0))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        for convz, convr, convq in ((self.convz1, self.convr1, self.convq1),
                                    (self.convz2, self.convr2, self.convq2)):
            hx = torch.cat([h, x], 1)
            z = torch.sigmoid(convz(hx))
            r = torch.sigmoid(convr(hx))
            q = torch.tanh(convq(torch.cat([r * h, x], 1)))
            h = (1 - z) * h + z * q
        return h


class FlowHead(nn.Module):
    def __init__(self, cin: int, hidden: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, hidden, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden, 2, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(x)))


class BasicUpdateBlock(nn.Module):
    def __init__(self, cfg: RAFTConfig):
        super().__init__()
        self.encoder = BasicMotionEncoder(cfg)
        self.gru = SepConvGRU(cfg.hidden_dim, cfg.context_dim + 128)
        self.flow_head = FlowHead(cfg.hidden_dim)
        self.mask = nn.Sequential(nn.Conv2d(cfg.hidden_dim, 256, 3, padding=1),
                                  nn.ReLU(inplace=True),
                                  nn.Conv2d(256, 64 * 9, 1))

    def forward(self, net, inp, corr, flow):
        """One refinement: the new GRU state and the flow update."""
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], 1))
        return net, self.flow_head(net)

    def upsample_mask(self, net: torch.Tensor) -> torch.Tensor:
        return 0.25 * self.mask(net)


class RAFT(nn.Module):
    def __init__(self, cfg: RAFTConfig = RAFTConfig()):
        super().__init__()
        self.cfg = cfg
        self.fnet = BasicEncoder(cfg.feature_dim, "instance")
        self.cnet = BasicEncoder(cfg.hidden_dim + cfg.context_dim, "batch")
        self.update_block = BasicUpdateBlock(cfg)


# ---------------------------------------------------------------------------
# Correlation pyramid and lookup
# ---------------------------------------------------------------------------

def corr_pyramid(f1: torch.Tensor, f2: torch.Tensor, levels: int
                 ) -> List[torch.Tensor]:
    """All-pairs correlation of (B, D, H, W) feature maps, / sqrt(D), as
    (B, H*W, H, W), then 2x2 average pooling per level with floor
    semantics: a level of width or height 1 pools to an empty level,
    which every lookup reads as zeros."""
    b, d, h, w = f1.shape
    corr = torch.bmm(f1.reshape(b, d, h * w).transpose(1, 2),
                     f2.reshape(b, d, h * w)) / math.sqrt(d)
    pyramid = [corr.reshape(b, h * w, h, w)]
    for _ in range(levels - 1):
        c = pyramid[-1]
        hl, wl = c.shape[2] // 2, c.shape[3] // 2
        c = c[:, :, :2 * hl, :2 * wl].reshape(b, h * w, hl, 2, wl, 2)
        pyramid.append(c.sum(dim=(3, 5)) / 4.0)
    return pyramid


def lookup_level(corr: torch.Tensor, coords: torch.Tensor, radius: int
                 ) -> torch.Tensor:
    """Bilinear radius lookup on one level: corr (B, N, Hl, Wl), coords
    (B, N, 2) xy in level pixels -> (B, N, (2r+1)^2) in coords' dtype,
    zero outside
    the level (grid_sample(align_corners=True, padding_mode='zeros')).

    The offsets keep the official CorrBlock's order, which convc1's
    trained weights depend on: the slow offset index moves x, the fast one
    y.  Corners are clipped into the level and masked, so a level one
    pixel wide needs no division by its width - 1."""
    b, n, hl, wl = corr.shape
    k = 2 * radius + 1
    if hl * wl == 0:
        return coords.new_zeros(b, n, k * k)
    d = torch.arange(-radius, radius + 1, dtype=coords.dtype,
                     device=coords.device)
    px = coords[..., 0:1] + d.repeat_interleave(k)
    py = coords[..., 1:2] + d.repeat(k)
    x0, y0 = px.floor(), py.floor()
    wx, wy = px - x0, py - y0
    flat = corr.reshape(b, n, hl * wl)
    out = torch.zeros_like(px)
    for xi, yi, wgt in ((x0, y0, (1 - wx) * (1 - wy)),
                        (x0 + 1, y0, wx * (1 - wy)),
                        (x0, y0 + 1, (1 - wx) * wy),
                        (x0 + 1, y0 + 1, wx * wy)):
        valid = (xi >= 0) & (xi <= wl - 1) & (yi >= 0) & (yi <= hl - 1)
        idx = (yi.clamp(0, hl - 1) * wl + xi.clamp(0, wl - 1)).long()
        out = out + torch.gather(flat, 2, idx).to(out.dtype) * (wgt * valid)
    return out


def corr_lookup(pyramid: List[torch.Tensor], coords: torch.Tensor,
                radius: int) -> torch.Tensor:
    """coords (B, 2, H, W) xy at 1/8 resolution -> (B, levels*(2r+1)^2,
    H, W), level-major channels."""
    b, _, h, w = coords.shape
    flat = coords.permute(0, 2, 3, 1).reshape(b, h * w, 2)
    out = torch.cat([lookup_level(c, flat / 2 ** i, radius)
                     for i, c in enumerate(pyramid)], -1)
    return out.permute(0, 2, 1).reshape(b, -1, h, w)


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

def upsample_flow(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Convex 8x upsampling: flow (B, 2, H, W), mask (B, 576, H, W) ->
    (B, 2, 8H, 8W), each fine pixel a softmax-weighted mix of the 3x3
    coarse neighbourhood of 8 * flow (zero padded)."""
    b, _, h, w = flow.shape
    m = torch.softmax(mask.view(b, 1, 9, 8, 8, h, w), dim=2)
    up = F.unfold(8 * flow, [3, 3], padding=1).view(b, 2, 9, 1, 1, h, w)
    up = (m * up).sum(dim=2)
    return up.permute(0, 1, 4, 2, 5, 3).reshape(b, 2, 8 * h, 8 * w)


def pad_to_multiple_of_8(img: torch.Tensor
                         ) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """Replicate-pad (B, H, W, C) to multiples of 8, split symmetrically
    like RAFT's InputPadder; returns (padded, (top, bottom, left,
    right))."""
    _, h, w, _ = img.shape
    ph, pw = (8 - h % 8) % 8, (8 - w % 8) % 8
    pads = (ph // 2, ph - ph // 2, pw // 2, pw - pw // 2)
    if ph or pw:
        rows = torch.arange(-pads[0], h + pads[1],
                            device=img.device).clamp(0, h - 1)
        cols = torch.arange(-pads[2], w + pads[3],
                            device=img.device).clamp(0, w - 1)
        img = img[:, rows][:, :, cols]
    return img, pads


def unpad(flow: torch.Tensor, pads: Tuple[int, ...]) -> torch.Tensor:
    t, bm, l, r = pads
    h, w = flow.shape[1], flow.shape[2]
    return flow[:, t:h - bm, l:w - r]


@contextlib.contextmanager
def full_f32():
    """float32 convolutions and products at full precision (TF32 off for
    cuDNN and cuBLAS), restored on exit."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


@contextlib.contextmanager
def without_cudnn():
    """Convolutions through PyTorch's own im2col + cuBLAS GEMM instead of
    cuDNN, restored on exit.  In float32 without TF32, cuDNN's heuristics
    give the motion encoder's 256 -> 126 3x3 convolution an FFT algorithm
    of thousands of launches that is 50-70x slower than the GEMM on an
    H100 (chip_smoke.py's flow phase prints both)."""
    saved = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = saved


def check_args(cfg: RAFTConfig, iters: int) -> None:
    if cfg.small:
        raise NotImplementedError(
            "RAFTConfig.small is not implemented: only the 'things' "
            "(large) architecture is; the SAIS reference uses only "
            "raft-things (extract_representations.py:267)")
    if iters < 1:
        # 0 iterations would return the convex upsampling of a zero flow
        raise ValueError(f"raft_forward needs iters >= 1, got {iters}")


def encode(model: RAFT, image1: torch.Tensor, image2: torch.Tensor,
           cfg: RAFTConfig, compute_dtype: torch.dtype):
    """Images (B, H, W, 3) in [0, 255] -> float32 feature maps f1, f2 and
    the float32 GRU state and context (net, inp), all (B, C, H/8, W/8)
    (float64 for a float64 compute_dtype)."""
    wide = torch.promote_types(compute_dtype, torch.float32)

    def prep(img):
        x = 2.0 * (img.to(wide) / 255.0) - 1.0
        return x.permute(0, 3, 1, 2).to(compute_dtype)

    x1, x2 = prep(image1), prep(image2)
    f1, f2 = model.fnet(torch.cat([x1, x2])).to(wide).chunk(2)
    cnet = model.cnet(x1)
    # the split is at hidden_dim, not in half
    net, inp = torch.split(cnet, [cfg.hidden_dim,
                                  cnet.shape[1] - cfg.hidden_dim], dim=1)
    return f1, f2, torch.tanh(net).to(wide), F.relu(inp).to(wide)


def refine(model: RAFT, pyramid: List[torch.Tensor], net: torch.Tensor,
           inp: torch.Tensor, radius: int, iters: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The update loop: (final GRU state, flow (B, 2, H/8, W/8))."""
    b, _, h, w = net.shape
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=net.dtype, device=net.device),
        torch.arange(w, dtype=net.dtype, device=net.device),
        indexing="ij")
    coords0 = torch.stack([xs, ys])[None].expand(b, 2, h, w)
    coords1 = coords0
    update = model.update_block
    with without_cudnn():
        for _ in range(iters):
            corr = corr_lookup(pyramid, coords1, radius)
            net, delta = update(net, inp, corr, coords1 - coords0)
            coords1 = coords1 + delta
    return net, coords1 - coords0


def raft_forward(model: RAFT, image1: torch.Tensor, image2: torch.Tensor,
                 cfg: Optional[RAFTConfig] = None,
                 iters: Optional[int] = None,
                 compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Flow image1 -> image2: images (B, H, W, 3), uint8 or float RGB in
    [0, 255], H and W multiples of 8 (`pad_to_multiple_of_8`) -> (B, H, W,
    2) flow in pixels (x, y), float32 (float64 for a float64 compute_dtype
    and model).  cfg defaults to the model's own."""
    cfg = model.cfg if cfg is None else cfg
    iters = cfg.iters if iters is None else iters
    check_args(cfg, iters)
    with full_f32():
        f1, f2, net, inp = encode(model, image1, image2, cfg, compute_dtype)
        pyramid = corr_pyramid(f1, f2, cfg.corr_levels)
        if cfg.corr_dtype == "bfloat16":
            pyramid = [c.to(torch.bfloat16) for c in pyramid]
        net, flow = refine(model, pyramid, net, inp, cfg.corr_radius, iters)
        # the mask from the final GRU state only
        up = upsample_flow(flow, model.update_block.upsample_mask(net))
    return up.permute(0, 2, 3, 1)


def raft_init(generator: torch.Generator,
              cfg: RAFTConfig = RAFTConfig()) -> RAFT:
    """Random model on the CPU with the 'things' checkpoint's shapes, as
    the JAX package initializes: He-normal convolutions (std sqrt(2 /
    fan_in)), zero biases, identity batch norms."""
    model = RAFT(cfg)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            else:
                fan = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=generator)
                        * (2.0 / fan) ** 0.5)
    return model.eval()
