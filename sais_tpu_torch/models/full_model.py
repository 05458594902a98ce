"""SAIS temporal model, Prototypes task, 'reps' data path.

Counterpart of `sais_tpu/models/full_model.py` (reference fullModel,
prepare_model.py:18-515):

  reps (B, S, F, D) + learned per-index positional embeddings
    -> prepend the learned frame CLS token
    -> 4-layer / 4-head encoder with key-padding mask (also returns the
       last layer's head-averaged attention; windows of flash_min_len
       tokens or more take K2 forward and K3 backward on the card, see
       `resolve_flash`)
    -> ReLU -> CLS track (B, S, D)
  mean over snippets -> RGB + Flow sum -> ReLU -> linear(384 -> 256) video
  rep (rows of a multi-task batch's second domain through linearB), and
  linear2(256 -> 3) auxiliary logits; with the importance head,
  importance(384 -> 1) over the full sequence.

Inference runs `prototypes_forward` under `torch.inference_mode`; training
(`train.loop.PrototypeTrainer`) runs the same function with gradients on,
through the flash path's autograd Function where it is taken.  Masks are
bool (B, S, F+1), True = padding; slot 0 (CLS) is never padded.  The clip
encoder, MIL modules and classification head wait for the slice that
trains them.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

from sais_tpu_torch.config import ModelConfig
from sais_tpu_torch.models.heads import importance_scores
from sais_tpu_torch.models.temporal import (TransformerEncoder,
                                            encoder_forward, encoder_init)


class FullModel(nn.Module):
    """The parameters the Prototypes path reads and trains: `importance`
    (the reference's importance_function) with cfg.importance_head, and
    `linearB` (prepare_model.py:48-49) with cfg.multi_task."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d = cfg.rep_dim
        self.frame_cls = nn.Parameter(torch.zeros(d))
        self.frame_pos = nn.Parameter(torch.zeros(cfg.temporal.max_positions,
                                                  d))
        self.frame_encoder = TransformerEncoder(cfg.temporal)
        self.linear = nn.Linear(d, cfg.proj_dim)
        self.linear2 = nn.Linear(cfg.proj_dim, cfg.aux_logit_dim)
        self.importance = nn.Linear(d, 1) if cfg.importance_head else None
        self.linearB = (nn.Linear(d, cfg.proj_dim) if cfg.multi_task
                        else None)


class TemporalOutput(NamedTuple):
    full_seq: torch.Tensor   # (B, S, F+1, D) post-ReLU encoder
    cls_seq: torch.Tensor    # (B, S, D)
    # last layer's head-averaged attention: (B*S, F+1, F+1) on the dense
    # path, the CLS-query row (B*S, F+1) on the flash path (K2)
    attn: torch.Tensor


class PrototypesOutput(NamedTuple):
    video_rep: torch.Tensor    # (B, proj_dim)
    aux_logits: torch.Tensor   # (B, 3)
    attn: torch.Tensor
    importances: Optional[torch.Tensor] = None   # (B, S, F+1, 1)


def cls_attention(attn: torch.Tensor) -> torch.Tensor:
    """Either attention form -> the CLS-query row (B*S, F+1): dense
    (B*S, F+1, F+1) -> row 0; the flash path's already is the row."""
    return attn[:, 0, :] if attn.dim() == 3 else attn


def resolve_flash(cfg: ModelConfig, seq_len: int, device: torch.device
                  ) -> bool:
    """Whether a window of `seq_len` tokens runs its attention on K2.

    cfg.temporal.use_flash True / False forces it (True on the CPU runs
    K2's plain version, as JAX runs interpret mode off a TPU); None = auto:
    K2 on a CUDA device once the window reaches flash_min_len tokens, the
    TPU rule with the card in the TPU's place.  Reads only the device type,
    so it needs no card to answer."""
    t = cfg.temporal
    if t.use_flash is not None:
        return bool(t.use_flash)
    return seq_len >= t.flash_min_len and device.type == "cuda"


def temporal_features(model: FullModel, reps: torch.Tensor,
                      pad_mask: Optional[torch.Tensor],
                      cfg: ModelConfig) -> TemporalOutput:
    """prepareInputForTransformer + aggregateInputs (prepare_model.py:179-221),
    with self-attention (the reference's -sa, which inference uses)."""
    b, s, f, d = reps.shape
    if f > model.frame_pos.shape[0]:
        raise ValueError(
            f"{f}-frame windows exceed the {model.frame_pos.shape[0]}-slot "
            "positional table; raise max_positions (--max-positions)")
    x = reps + model.frame_pos[:f].to(reps.dtype)[None, None]
    cls = model.frame_cls.to(reps.dtype).expand(b, s, 1, d)
    x = torch.cat([cls, x], dim=2).reshape(b * s, f + 1, d)
    mask = pad_mask.reshape(b * s, f + 1) if pad_mask is not None else None
    out, attn = encoder_forward(model.frame_encoder, x, cfg.temporal, mask,
                                use_flash=resolve_flash(cfg, f + 1,
                                                        reps.device))
    full_seq = torch.relu(out).reshape(b, s, f + 1, d)
    return TemporalOutput(full_seq, full_seq[:, :, 0, :], attn)


def prototypes_forward(model: FullModel, cfg: ModelConfig,
                       rgb: Optional[torch.Tensor] = None,
                       rgb_mask: Optional[torch.Tensor] = None,
                       flow: Optional[torch.Tensor] = None,
                       flow_mask: Optional[torch.Tensor] = None,
                       primary_domain: Optional[torch.Tensor] = None
                       ) -> PrototypesOutput:
    """Prototypes-task forward for one TTA version of the inputs
    (prepare_model.py:304-421): each modality runs the shared frame
    encoder, snippet CLS tracks are mean-pooled, RGB and Flow are summed
    before the projection; attention and the full sequence (which the
    importance head reads, when cfg.importance_head and the model has one)
    come from RGB when present.

    primary_domain: optional (B,) bool for the multi-task setting ('+' in
    domain, prepare_model.py:406-416): True rows project through `linear`
    (the NH_02 head), False rows through `linearB`."""
    pooled = attn = full_seq = None
    if cfg.modalities in ("RGB", "RGB-Flow"):
        t = temporal_features(model, rgb, rgb_mask, cfg)
        pooled, attn, full_seq = t.cls_seq.mean(dim=1), t.attn, t.full_seq
    if cfg.modalities in ("Flow", "RGB-Flow"):
        tf = temporal_features(model, flow, flow_mask, cfg)
        fpooled = tf.cls_seq.mean(dim=1)
        pooled = fpooled if pooled is None else pooled + fpooled
        if attn is None:
            attn, full_seq = tf.attn, tf.full_seq
    act = torch.relu(pooled)
    if primary_domain is not None:
        if model.linearB is None:
            # routing secondary-domain rows through the primary head would
            # silently produce wrong video reps
            raise ValueError(
                "primary_domain given but the model has no 'linearB' head — "
                "it was built without multi_task (prepare_model.py:47-50 "
                "linearB)")
        video_rep = torch.where(primary_domain[:, None], model.linear(act),
                                model.linearB(act))
    else:
        video_rep = model.linear(act)
    aux_logits = model.linear2(torch.relu(video_rep))
    importances = None
    if cfg.importance_head and model.importance is not None:
        importances = importance_scores(full_seq, model.importance)
    return PrototypesOutput(video_rep, aux_logits, attn, importances)


def full_model_init(generator: torch.Generator, cfg: ModelConfig
                    ) -> FullModel:
    """Random model on the CPU, as the reference (prepare_model.py:47-96):
    uniform [0, 1) CLS token and pos-embedding table (torch.rand), torch
    Linear default init for the projections; the importance and linearB
    heads, where the config has them, are drawn last."""
    model = FullModel(cfg)

    def linear_(lin):
        lim = (1.0 / lin.in_features) ** 0.5
        for p in (lin.weight, lin.bias):
            p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1) * lim)

    with torch.no_grad():
        model.frame_cls.copy_(torch.rand(model.frame_cls.shape,
                                         generator=generator))
        model.frame_pos.copy_(torch.rand(model.frame_pos.shape,
                                         generator=generator))
        linear_(model.linear)
        linear_(model.linear2)
    encoder_init(model.frame_encoder, generator, cfg.temporal)
    with torch.no_grad():
        for lin in (model.importance, model.linearB):
            if lin is not None:
                linear_(lin)
    return model


def prototypes_init(generator: torch.Generator, nclasses: int,
                    proj_dim: int = 256) -> Tuple[List[str], torch.Tensor]:
    """Fresh prototypes: keys '0'..'nclasses-1', uniform [0, 1) rows
    (prepare_model.py:555-560)."""
    return ([str(i) for i in range(nclasses)],
            torch.rand((nclasses, proj_dim), generator=generator))
