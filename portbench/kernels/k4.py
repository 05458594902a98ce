"""K4 `fused_block_fwd_train`: the ViT block's training forward in bf16,
which also writes the post-attention residual x1 and takes per-row branch
scales (stochastic depth)."""

TARGETS = ["sais_tpu_torch.kernels.fused_mha:fused_block_fwd_train"]
PEAK = "bf16_flops"


def capture(x, qkv_w, qkv_b, proj_w, proj_b, fc1_w, fc1_b, fc2_w, fc2_b,
            *rest, **kw):
    b, l, d = x.shape
    return b, l, d, fc1_w.shape[1]


def work(cap):
    """24 L D^2 + 4 L^2 D a row of images at MLP width 4 D (the four
    products and the two attention products); bytes: x, x1 and the output
    (bf16), the two branch scales, the bf16 weights once."""
    b, l, d, mlp = cap
    act, scale = 2 * b * l * d, 2 * b * l
    w_mlp = 2 * d * mlp + mlp + 3 * d
    w_attn = 4 * d * d + 4 * d + 2 * d
    flops = 2 * b * l * d * (4 * d + 2 * mlp) + 4 * b * l * l * d
    return flops, 3 * act + 2 * scale + 2 * (w_mlp + w_attn)
