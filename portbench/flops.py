"""The operations a model needs for a unit of work (a frame, a training
step, a DINO image), counted from the shapes: two flops a multiply-add of
every product the architecture defines, over valid tokens and valid
(query, key) pairs; elementwise work, normalisation and softmax are not
counted."""

from __future__ import annotations

from typing import Sequence


def vit_forward(tokens: int, d: int, depth: int, mlp: int,
                patch_dim: int) -> float:
    """One image through a ViT: the patch embedding, then per block qkv,
    proj, fc1, fc2 over every token and q k^T, p v over every pair."""
    blocks = depth * (2 * tokens * d * (4 * d + 2 * mlp)
                      + 4 * tokens * tokens * d)
    return 2 * (tokens - 1) * patch_dim * d + blocks


def vit_tokens(image: int, patch: int) -> int:
    return (image // patch) ** 2 + 1


def temporal_train_step(valid_tokens: Sequence[int], d: int, ffn: int,
                        layers: int, proj: int = 256) -> float:
    """One training step of the post-norm temporal encoder over sequences
    of `valid_tokens` (CLS included): forward in_proj, out_proj, the FFN
    and the two attention products over valid pairs, the backward twice
    the forward; the projection head's product is counted likewise."""
    fwd = 0.0
    for v in valid_tokens:
        fwd += layers * (8 * v * d * d + 4 * v * d * ffn + 4 * v * v * d)
        fwd += 2 * d * proj
    return 3 * fwd


def dino_image(vit: dict, dino: dict) -> float:
    """One image of a DINO step: the student's forward and backward (three
    forwards) over its global and local crops, the teacher's forward over
    the global crops, the head's MLP likewise, and the last layer's
    products as K7 needs them (2 db K (3 rows_student + rows_teacher))."""
    d, depth, mlp = vit["embed_dim"], vit["depth"], vit["mlp_dim"]
    patch = vit["patch_size"]
    pdim = patch * patch * vit["in_channels"]
    g = vit_forward(vit_tokens(dino["global_size"], patch), d, depth, mlp,
                    pdim)
    loc = vit_forward(vit_tokens(dino["local_size"], patch), d, depth, mlp,
                      pdim)
    ng, nl = dino["n_global_crops"], dino["n_local_crops"]
    hidden, bottleneck, k = dino["head_hidden"], dino["head_bottleneck"], \
        dino["out_dim"]
    head = 2 * (d * hidden + hidden * hidden + hidden * bottleneck)
    rows_s, rows_t = ng + nl, ng
    return (3 * (ng * g + nl * loc) + ng * g + head * (3 * rows_s + rows_t)
            + 2 * bottleneck * k * (3 * rows_s + rows_t))
