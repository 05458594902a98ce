"""K1 `fused_vit_block`: the ViT block's inference forward in bf16 (LN,
qkv, attention, proj + residual, LN, MLP + residual), one call a block."""

TARGETS = ["sais_tpu_torch.models.vit:fused_vit_block"]
PEAK = "bf16_flops"


def capture(x, qkv_w, qkv_b, proj_w, proj_b, fc1_w, fc1_b, fc2_w, fc2_b,
            *rest, valid_len=None, **kw):
    b, l, d = x.shape
    weights = sum(t.numel() * t.element_size() for t in
                  (qkv_w, qkv_b, proj_w, proj_b, fc1_w, fc1_b, fc2_w, fc2_b,
                   *rest[:4]))
    return (b, l, d, fc1_w.shape[1], l if valid_len is None else valid_len,
            x.element_size(), weights)


def work(cap):
    """(flops, bytes): the four products over every token and the two
    attention products over the valid keys; x read and the output
    written once, the weights read once."""
    b, l, d, mlp, valid, size, weights = cap
    flops = 2 * b * l * d * (3 * d + d + 2 * mlp) + 4 * b * l * valid * d
    return flops, 2 * b * l * d * size + weights
