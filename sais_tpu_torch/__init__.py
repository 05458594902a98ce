"""SAIS on PyTorch and CUDA for NVIDIA Hopper (H100).

A port of `sais_tpu` (JAX / Pallas on a TPU).  It mirrors that package's
module layout so each module's counterpart is easy to find, but it imports
nothing of it: the JAX package is the reference the port is tested against.

Importing this package loads only torch; CUDA kernels are built at their
first launch (`kernels/_build.py`).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: `None` means the card ("cuda").

    Raises when a CUDA device is asked for (explicitly or by default) and
    none is present: the port never falls back to the CPU on its own.
    Callers that want the CPU (the tests) pass `device="cpu"`.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "sais_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' (CLI: --device cpu) to run the "
            "plain PyTorch versions on the CPU")
    return dev
