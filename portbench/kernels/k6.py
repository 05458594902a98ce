"""K6 `fused_block_bwd_attn`: the backward of the ViT block's attention
half (LN1, qkv and attention recomputed, the activation and weight
gradients)."""

TARGETS = ["sais_tpu_torch.kernels.fused_mha:fused_block_bwd_attn"]
PEAK = "bf16_flops"


def capture(x, dx1, *rest, **kw):
    b, l, d = x.shape
    return b, l, d


def work(cap):
    """22 L D^2 + 12 L^2 D a row of images (qkv again, its two gradients,
    proj's two, and the attention's forward and backward products); bytes:
    x, dx1 and dx (bf16), the scale, the attention half's weights read and
    their f32 gradients written."""
    b, l, d = cap
    act, scale = 2 * b * l * d, 2 * b * l
    w_attn = 4 * d * d + 4 * d + 2 * d
    return (22 * b * l * d * d + 12 * b * l * l * d,
            3 * act + scale + 6 * w_attn)
