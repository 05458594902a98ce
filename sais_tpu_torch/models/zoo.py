"""Named DINO backbone geometries (dino-main/hubconf.py:22-81), for
`pretrain --arch`.

Counterpart of `config` in `sais_tpu/models/zoo.py`: vits16 / vits8 /
vitb16 / vitb8 and their torch-hub aliases dino_*.  Every geometry runs on
the card: at 224 px the patch-8 ones have 785 tokens, which the ViT-block
kernels (K1, K4-K6, K8) take through their key-tiled attention.
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

