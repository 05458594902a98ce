"""Named DINO backbone geometries (dino-main/hubconf.py:22-81), for
`pretrain --arch`.

Counterpart of `config` in `sais_tpu/models/zoo.py`: vits16 / vits8 /
vitb16 / vitb8 and their torch-hub aliases dino_*.  At 224 px the patch-8
geometries have 785 tokens, past the 256 the ViT-block kernels take
(K1, K4-K6), so they are refused on a CUDA device (`check_fused_length`).
"""

from __future__ import annotations

from sais_tpu_torch.config import ViTConfig

# hubconf.py geometry table: vit_small(patch_size=...) at :27/42 and
# vit_base at :57/72; vision_transformer.py:243-255 supplies
# embed_dim/depth/heads for each family.
CONFIGS = {
    "vits16": ViTConfig(patch_size=16, embed_dim=384, depth=12, num_heads=6),
    "vits8": ViTConfig(patch_size=8, embed_dim=384, depth=12, num_heads=6),
    "vitb16": ViTConfig(patch_size=16, embed_dim=768, depth=12,
                        num_heads=12),
    "vitb8": ViTConfig(patch_size=8, embed_dim=768, depth=12, num_heads=12),
}

ALIASES = {
    "dino_vits16": "vits16",
    "dino_vits8": "vits8",
    "dino_vitb16": "vitb16",
    "dino_vitb8": "vitb8",
}


def config(name: str) -> ViTConfig:
    """ViTConfig for a zoo name (accepts hubconf aliases)."""
    key = ALIASES.get(name, name)
    if key not in CONFIGS:
        raise KeyError(f"unknown model {name!r}; choose from "
                       f"{sorted(CONFIGS) + sorted(ALIASES)}")
    return CONFIGS[key]


def check_fused_length(name: str, cfg: ViTConfig, image_size: int) -> None:
    """Refuse a geometry whose token count at image_size exceeds what the
    ViT-block kernels take (K1, K4-K6: 256 tokens)."""
    from sais_tpu_torch.kernels.fused_mha import MAX_LEN
    tokens = (image_size // cfg.patch_size) ** 2 + 1
    if tokens > MAX_LEN:
        raise NotImplementedError(
            f"--arch {name}: {tokens} tokens at {image_size} px, past the "
            f"{MAX_LEN} the ViT-block kernels take on the card; longer "
            "sequences are open work (ROADMAP.md Queue 2, 'Still to port: "
            "the long-sequence range of the ViT-block kernels')")
