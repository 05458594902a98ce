"""K5 `fused_block_bwd_mlp`: the backward of the ViT block's MLP half
(fc1 recomputed, GELU's derivative, the activation and weight
gradients)."""

TARGETS = ["sais_tpu_torch.kernels.fused_mha:fused_block_bwd_mlp"]
PEAK = "bf16_flops"


def capture(x1, dout, fc1_w, *rest, **kw):
    b, l, d = x1.shape
    return b, l, d, fc1_w.shape[1]


def work(cap):
    """Five products of 2 L D mlp (fc1 again, dh, dW2, dx, dW1): 40 L D^2
    at MLP width 4 D; bytes: x1, dout and dx (bf16), the scale, the MLP's
    weights read and their f32 gradients written."""
    b, l, d, mlp = cap
    act, scale = 2 * b * l * d, 2 * b * l
    w_mlp = 2 * d * mlp + mlp + 3 * d
    return 10 * b * l * d * mlp, 3 * act + scale + 6 * w_mlp
