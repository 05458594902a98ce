"""SAIS temporal model, Prototypes task, 'reps' data path.

Counterpart of `sais_tpu/models/full_model.py` (reference fullModel,
prepare_model.py:18-515), inference only:

  reps (B, S, F, D) + learned per-index positional embeddings
    -> prepend the learned frame CLS token
    -> 4-layer / 4-head encoder with key-padding mask (also returns the
       last layer's head-averaged attention)
    -> ReLU -> CLS track (B, S, D)
  mean over snippets -> RGB + Flow sum -> ReLU -> linear(384 -> 256) video
  rep, and linear2(256 -> 3) auxiliary logits.

Masks are bool (B, S, F+1), True = padding; slot 0 (CLS) is never padded.
The clip encoder, MIL modules and the classification head wait for the
training slice.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

from sais_tpu_torch.config import ModelConfig
from sais_tpu_torch.models.temporal import (TransformerEncoder,
                                            encoder_forward, encoder_init)


class FullModel(nn.Module):
    """The parameters the Prototypes inference path reads."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d = cfg.rep_dim
        self.frame_cls = nn.Parameter(torch.zeros(d))
        self.frame_pos = nn.Parameter(torch.zeros(cfg.temporal.max_positions,
                                                  d))
        self.frame_encoder = TransformerEncoder(cfg.temporal)
        self.linear = nn.Linear(d, cfg.proj_dim)
        self.linear2 = nn.Linear(cfg.proj_dim, cfg.aux_logit_dim)


class TemporalOutput(NamedTuple):
    full_seq: torch.Tensor   # (B, S, F+1, D) post-ReLU encoder
    cls_seq: torch.Tensor    # (B, S, D)
    attn: torch.Tensor       # (B*S, F+1, F+1) last layer, head-averaged


class PrototypesOutput(NamedTuple):
    video_rep: torch.Tensor    # (B, proj_dim)
    aux_logits: torch.Tensor   # (B, 3)
    attn: torch.Tensor


def resolve_flash(cfg: ModelConfig, seq_len: int, device: torch.device
                  ) -> bool:
    """Whether a window of `seq_len` tokens takes flash attention.  The
    flash kernel (K2, sais_tpu/kernels/flash_attention.py) is not ported
    yet, so this returns False or raises: forcing it raises, and in auto
    mode a window of flash_min_len tokens or more raises on CUDA rather
    than silently taking the dense path where the TPU would not.  Off the
    card, auto mode stays dense, as the JAX package does off a TPU."""
    t = cfg.temporal
    if t.use_flash:
        raise NotImplementedError(
            "use_flash=True: the flash-attention kernel K2 "
            "(sais_tpu/kernels/flash_attention.py) is not ported yet")
    if t.use_flash is None and seq_len >= t.flash_min_len \
            and device.type == "cuda":
        raise NotImplementedError(
            f"a {seq_len}-token window takes flash attention (K2) in auto "
            f"mode (flash_min_len={t.flash_min_len}), which is not ported "
            "yet; set use_flash=False to run it dense")
    return False


def temporal_features(model: FullModel, reps: torch.Tensor,
                      pad_mask: Optional[torch.Tensor],
                      cfg: ModelConfig) -> TemporalOutput:
    """prepareInputForTransformer + aggregateInputs (prepare_model.py:179-221),
    with self-attention (the reference's -sa, which inference uses)."""
    b, s, f, d = reps.shape
    x = reps + model.frame_pos[:f].to(reps.dtype)[None, None]
    cls = model.frame_cls.to(reps.dtype).expand(b, s, 1, d)
    x = torch.cat([cls, x], dim=2).reshape(b * s, f + 1, d)
    mask = pad_mask.reshape(b * s, f + 1) if pad_mask is not None else None
    resolve_flash(cfg, f + 1, reps.device)
    out, attn = encoder_forward(model.frame_encoder, x, cfg.temporal, mask)
    full_seq = torch.relu(out).reshape(b, s, f + 1, d)
    return TemporalOutput(full_seq, full_seq[:, :, 0, :], attn)


def prototypes_forward(model: FullModel, cfg: ModelConfig,
                       rgb: Optional[torch.Tensor] = None,
                       rgb_mask: Optional[torch.Tensor] = None,
                       flow: Optional[torch.Tensor] = None,
                       flow_mask: Optional[torch.Tensor] = None
                       ) -> PrototypesOutput:
    """Prototypes-task forward for one TTA version of the inputs
    (prepare_model.py:304-421): each modality runs the shared frame
    encoder, snippet CLS tracks are mean-pooled, RGB and Flow are summed
    before the projection; attention comes from RGB when present."""
    pooled = attn = None
    if cfg.modalities in ("RGB", "RGB-Flow"):
        t = temporal_features(model, rgb, rgb_mask, cfg)
        pooled, attn = t.cls_seq.mean(dim=1), t.attn
    if cfg.modalities in ("Flow", "RGB-Flow"):
        tf = temporal_features(model, flow, flow_mask, cfg)
        fpooled = tf.cls_seq.mean(dim=1)
        pooled = fpooled if pooled is None else pooled + fpooled
        if attn is None:
            attn = tf.attn
    video_rep = model.linear(torch.relu(pooled))
    aux_logits = model.linear2(torch.relu(video_rep))
    return PrototypesOutput(video_rep, aux_logits, attn)


def full_model_init(generator: torch.Generator, cfg: ModelConfig
                    ) -> FullModel:
    """Random model on the CPU, as the reference (prepare_model.py:47-96):
    uniform [0, 1) CLS token and pos-embedding table (torch.rand), torch
    Linear default init for the projections."""
    model = FullModel(cfg)
    with torch.no_grad():
        model.frame_cls.copy_(torch.rand(model.frame_cls.shape,
                                         generator=generator))
        model.frame_pos.copy_(torch.rand(model.frame_pos.shape,
                                         generator=generator))
        for lin in (model.linear, model.linear2):
            lim = (1.0 / lin.in_features) ** 0.5
            for p in (lin.weight, lin.bias):
                p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1)
                        * lim)
    encoder_init(model.frame_encoder, generator, cfg.temporal)
    return model


def prototypes_init(generator: torch.Generator, nclasses: int,
                    proj_dim: int = 256) -> Tuple[List[str], torch.Tensor]:
    """Fresh prototypes: keys '0'..'nclasses-1', uniform [0, 1) rows
    (prepare_model.py:555-560)."""
    return ([str(i) for i in range(nclasses)],
            torch.rand((nclasses, proj_dim), generator=generator))
