"""Operand precision of the references' products."""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
import torch.nn.functional as F

Round = Optional[Callable[[torch.Tensor], torch.Tensor]]


@contextlib.contextmanager
def float32_exact(tf32: bool = False):
    """Float32 products without TF32 (or with it, for a control)."""
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale a tensor (its absolute
    maximum onto 448), back in float32; the rounding's gradient is the
    identity."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = 448.0 / amax
    q = (x.detach() * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (q - x.detach())


def _r(rnd: Round, t: torch.Tensor) -> torch.Tensor:
    return t if rnd is None else rnd(t)


def mm(a, b, rnd: Round = None):
    return torch.matmul(_r(rnd, a), _r(rnd, b))


def linear(x, w, b=None, rnd: Round = None):
    return F.linear(_r(rnd, x), _r(rnd, w), b)


def conv(x, w, b, stride, rnd: Round = None):
    return F.conv2d(_r(rnd, x), _r(rnd, w), b, stride=stride)
