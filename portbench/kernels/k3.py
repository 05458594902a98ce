"""K3, the flash-attention backward of the temporal encoder (f32 accuracy
through 3xTF32 products)."""

import importlib.util
import os

TARGETS = ["sais_tpu_torch.kernels.flash_attention:_attention_bwd"]
PEAK = "f32_3xtf32_flops"

_spec = importlib.util.spec_from_file_location(
    "portbench_kernels_k2_for_k3", os.path.join(os.path.dirname(__file__),
                                                 "k2.py"))
_k2 = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_k2)


def capture(q, k, v, bias, *rest, **kw):
    return q.shape, k.shape[2], bias


def work(cap):
    """Five products of 2 Dh flops for each (valid query, valid key) pair;
    q, k, v, out, dO, lse and the bias read and dq, dk, dv written once."""
    (b, h, lq, dh), lk, bias = cap
    valid = _k2.valid_keys(bias, b, lk)
    flops = float(10 * h * dh * (valid * valid).sum())
    return flops, 4 * (8 * b * h * lq * dh + b * lk + b * h * lq)
