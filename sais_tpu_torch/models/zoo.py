"""Named DINO backbones (dino-main/hubconf.py:22-81), for `pretrain
--arch` and library callers.

Counterpart of `sais_tpu/models/zoo.py`: `config` and `create` for vits16
/ vits8 / vitb16 / vitb8 and their torch-hub aliases dino_*.  Every
geometry runs on the card: at 224 px the patch-8 ones have 785 tokens,
which the ViT-block kernels (K1, K4-K6, K8) take through their key-tiled
attention.  There is no download path: `create` loads a local .pth.

    model, cfg = zoo.create("vits16", torch.Generator().manual_seed(0))
    model, cfg = zoo.create("vitb8", torch_checkpoint="dino_vitb8.pth")
    feats = vit_features(model.cuda(), images)
"""

from __future__ import annotations

from typing import Optional

import torch

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



def create(name: str, generator: Optional[torch.Generator] = None,
           torch_checkpoint: Optional[str] = None):
    """(VisionTransformer, ViTConfig) for a named DINO backbone, float32 on
    the CPU.

    torch_checkpoint: a local .pth in the facebookresearch release layout,
    a plain backbone state_dict or a DINO training checkpoint whose
    student keys are stripped (the two layouts of
    extract_representations.py:181-203).  Without one, `vit_init` from
    `generator` (seed 0 when None)."""
    from sais_tpu_torch.models.vit import VisionTransformer, vit_init
    cfg = config(name)
    if torch_checkpoint is not None:
        from sais_tpu_torch.port.weights import load_dino_weights
        model = VisionTransformer(cfg)
        model.load_state_dict(load_dino_weights(torch_checkpoint))
        return model, cfg
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return vit_init(generator, cfg), cfg
