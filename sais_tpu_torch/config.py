"""Typed configuration for the port: the dataclasses of `sais_tpu.config`
that the decoding (RGB and flow), Prototypes training and skill paths
read, copied with the same fields and defaults (the reference values),
and the per-video fps tables of the skill path's flow jump.

- window geometry:   prepare_dataset.py:1711-1715 (0.5 s windows @ 30 fps)
- TTA offsets:       prepare_dataset.py:2649-2651 (+0, +3, +6 frames)
- temporal encoder:  prepare_model.py:74-81 (4 layers, 4 heads, d_model=rep_dim)
- post-processing:   process_inference_results.py:230-234
- training loop:     train.py:46-96, prepare_model.py:566-567
- preprocessing:     extract_representations.py:145-162, main_dino.py:300-326
- ViT-S/16:          dino-main/vision_transformer.py:243-247
- RAFT 'things':     extract_representations.py:264-288 (ptlflow raft)
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """DINO ViT backbone (dino-main/vision_transformer.py:134-247)."""

    image_size: int = 224
    patch_size: int = 16
    embed_dim: int = 384
    depth: int = 12
    num_heads: int = 6
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    layernorm_eps: float = 1e-6
    in_channels: int = 3

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size * self.grid_size

    @property
    def mlp_dim(self) -> int:
        return int(self.embed_dim * self.mlp_ratio)


@dataclasses.dataclass(frozen=True)
class PreprocessConfig:
    """Center-crop 0.8/0.8, resize to 224, ImageNet normalization
    (main_dino.py:300-326, extract_representations.py:145-162)."""

    crop_height_frac: float = 0.8
    crop_width_frac: float = 0.8
    resize: int = 224
    mean: Sequence[float] = (0.485, 0.456, 0.406)
    std: Sequence[float] = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class TemporalConfig:
    """Post-norm, ReLU torch TransformerEncoder over per-frame features
    (prepare_model.py:74-81): ffn 2048, LayerNorm eps 1e-5.

    use_flash: True / False forces the flash-attention kernel K2 in the
    encoder, None (auto) takes it on a CUDA device for windows of
    flash_min_len tokens or more; see `models.full_model.resolve_flash`."""

    rep_dim: int = 384
    num_layers: int = 4
    num_heads: int = 4
    ffn_dim: int = 2048
    layernorm_eps: float = 1e-5
    max_positions: int = 2000  # learned pos-emb table (prepare_model.py:67)
    use_flash: Optional[bool] = None
    flash_min_len: int = 512


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """SAIS temporal model (prepare_model.py:18-515).  self_attention=False
    is the reference CLI without -sa (prepare_model.py:296-301): snippets
    become plain frame means; data_type 'raw' adds the cls_head that the
    raw-video path trains (prepare_model.py:423-440)."""

    rep_dim: int = 384
    proj_dim: int = 256          # linear: rep_dim -> 256 (prepare_model.py:47)
    aux_logit_dim: int = 3       # linear2: 256 -> 3 (prepare_model.py:50)
    nclasses: int = 2
    n_attention_classes: int = 3  # MIL per-class modules (prepare_model.py:88)
    modalities: str = "RGB-Flow"  # 'RGB' | 'Flow' | 'RGB-Flow'
    importance_head: bool = False  # importance_function (prepare_model.py:55-56)
    multi_task: bool = False     # '+'-joined domains -> linearB head
    self_attention: bool = True
    data_type: str = "reps"      # 'raw' | 'reps'
    temporal: TemporalConfig = dataclasses.field(default_factory=TemporalConfig)


@dataclasses.dataclass(frozen=True)
class WindowConfig:
    """Sliding windows over unlabeled video (prepare_dataset.py:1711-1715,
    2642-2651).  The first window starts at frame index -1, which wraps to
    the last frame like numpy (data/windows.py keeps that)."""

    duration_s: float = 0.5
    hop_s: float = 0.5
    fps: float = 30.0
    stride_divisor: int = 10
    tta_offsets: Sequence[int] = (0, 3, 6)
    flow_jump_factor: int = 15   # fps // 2 (generate_paths.py:43)

    @property
    def duration_frames(self) -> int:
        return int(self.duration_s * self.fps)

    @property
    def hop_frames(self) -> int:
        return int(self.hop_s * self.fps)


@dataclasses.dataclass(frozen=True)
class PostprocessConfig:
    """Gesture CSV post-processing (process_inference_results.py:230-244)."""

    decision_threshold: float = 0.515
    entropy_threshold: float = 0.66
    merge_gap_s: int = 3
    fps: int = 30
    class_names: Sequence[str] = ("in-view", "out-of-view")


# ---------------------------------------------------------------------------
# Per-video fps tables (config data the reference scatters through code)
# ---------------------------------------------------------------------------
# prepare_dataset.py:24-26: the VUA training videos' fps, used to derive the
# flow jump size (jump = fps // 2, prepare_dataset.py:2245).  The reference
# ships only video '1' at 20 fps.
VUA_FPS_TABLE = {"1": 20.0}

# extract_representations.py:437-463: per-video fps for the HMH hospital's
# videos, used when generating flows (jump_size = fps // 2) and when loading
# flow reps for HMH_inference (prepare_dataset.py:1960).
HMH_FPS_TABLE = {
    "HMV1": 30.0, "HMV2": 30.0, "HMV3": 30.0,
    "HMV4": 60.0, "HMV5": 60.0, "HMV6": 60.0, "HMV7": 60.0,
    "HMV8": 59.94, "HMV9": 59.94, "HMV10": 59.94, "HMV11": 59.94,
    "HMV12": 59.94, "HMV13": 59.94, "HMV14": 59.94, "HMV15": 59.94,
    "HMV16": 59.94, "HMV17": 59.94, "HMV18": 59.94, "HMV19": 59.94,
    "HMV20": 59.94, "HMV21": 59.94, "HMV22": 59.94,
    "HMV23": 29.97, "HMV24": 29.97, "HMV25": 29.97, "HMV26": 29.97,
}

# Dataset-keyed flow jump sizes for inference phases
# (prepare_dataset.py:2240-2245: Gronau fixed 15, Lab/AFB fixed 30,
# HMH per-video fps // 2, VUA per-video fps // 2).
FLOW_JUMP_BY_PHASE = {"Gronau_inference": 15, "Lab_inference": 30,
                      "AFB_inference": 30}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training loop (train.py:46-96, prepare_model.py:566-567)."""

    lr: float = 0.1              # main.sh:27 '-lr 1e-1'
    nepochs: int = 50
    max_patience: int = 5        # train.py:48
    batch_size: int = 2          # main.sh:27 '-bs 2'
    importance_loss: bool = False


@dataclasses.dataclass(frozen=True)
class RAFTConfig:
    """RAFT optical-flow estimator (ptlflow 'raft' with the 'things'
    checkpoint), run over frame pairs flow_jump_factor frames apart
    (extract_representations.py:264-288).  corr_dtype: the stored
    correlation pyramid's dtype ('float32', the checkpoint-parity default,
    or 'bfloat16')."""

    hidden_dim: int = 128
    context_dim: int = 128
    feature_dim: int = 256
    corr_levels: int = 4
    corr_radius: int = 4
    iters: int = 32              # RAFT 'things' eval default
    small: bool = False
    corr_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """End-to-end configuration for `extract`, `flow` and `decode`."""

    vit: ViTConfig = dataclasses.field(default_factory=ViTConfig)
    preprocess: PreprocessConfig = dataclasses.field(default_factory=PreprocessConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    window: WindowConfig = dataclasses.field(default_factory=WindowConfig)
    postprocess: PostprocessConfig = dataclasses.field(default_factory=PostprocessConfig)
    raft: RAFTConfig = dataclasses.field(default_factory=RAFTConfig)
    compute_dtype: str = "bfloat16"
