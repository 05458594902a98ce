"""K2, the flash-attention forward of the temporal encoder (f32 accuracy
through 3xTF32 products)."""

TARGETS = ["sais_tpu_torch.kernels.flash_attention:_attention_fwd"]
PEAK = "f32_3xtf32_flops"


def capture(q, k, v, bias, *rest, **kw):
    # the bias (B, Lk) is kept by reference and read after the window
    return q.shape, k.shape[2], bias


def valid_keys(bias, b, lk):
    """Valid keys an element: the bias is 0 on valid keys and a large
    negative number on padded ones."""
    import torch
    if bias is None:
        return torch.full((b,), lk, dtype=torch.float64)
    return (bias.reshape(b, -1) > -1.0).sum(-1).double().cpu()


def work(cap):
    """4 Dh flops for each (valid query, valid key) pair of every head; q,
    k, v, the bias read and out, lse written once (f32)."""
    (b, h, lq, dh), lk, bias = cap
    valid = valid_keys(bias, b, lk)
    flops = float(4 * h * dh * (valid * valid).sum())
    return flops, 4 * (4 * b * h * lq * dh + b * lk + b * h * lq)
