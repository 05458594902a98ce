"""SAIS temporal model on the 'reps' data path.

Counterpart of `sais_tpu/models/full_model.py` (reference fullModel,
prepare_model.py:18-515):

  reps (B, S, F, D) + learned per-index positional embeddings
    -> prepend the learned frame CLS token
    -> 4-layer / 4-head encoder with key-padding mask (also returns the
       last layer's head-averaged attention; windows of flash_min_len
       tokens or more take K2 forward and K3 backward on the card, see
       `resolve_flash`)
    -> ReLU -> CLS track (B, S, D)
  (without self-attention, the reference CLI without -sa: the CLS track
  is the plain frame mean, pad rows included)

Task heads:
  Prototypes: mean over snippets -> RGB + Flow sum -> ReLU -> linear(384 ->
    256) video rep (rows of a multi-task batch's second domain through
    linearB), and linear2(256 -> 3) auxiliary logits; with the importance
    head, importance(384 -> 1) over the full sequence;
  MIL: clip pos-embeddings + the clip encoder (unmasked, dense) over the
    CLS track -> gated-attention head (prepare_model.py:452-488);
  ClassificationHead: cls_head over the CLS track (prepare_model.py:423-440;
    the model has it only for data_type 'raw', as in the JAX package).

Inference runs `prototypes_forward` under `torch.inference_mode`; the
trainers run the forwards with gradients on, through the flash path's
autograd Function where it is taken.  Masks are bool (B, S, F+1), True =
padding; slot 0 (CLS) is never padded.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

from sais_tpu_torch.config import ModelConfig
from sais_tpu_torch.models.heads import importance_scores, mil_head
from sais_tpu_torch.models.temporal import (TransformerEncoder,
                                            encoder_forward, encoder_init)


class FullModel(nn.Module):
    """The reference's parameter inventory (prepare_model.py:47-96), as the
    JAX package's tree always holds it: the frame and clip CLS tokens,
    positional tables and encoders, the Prototypes projections, and the
    MIL modules (attentionA / B, per-class attention_modules and
    final_modules).  `importance` (the reference's importance_function)
    with cfg.importance_head, `linearB` (prepare_model.py:48-49) with
    cfg.multi_task, `cls_head` with cfg.data_type 'raw'."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d, e, n = cfg.rep_dim, cfg.proj_dim, cfg.temporal.max_positions
        self.frame_cls = nn.Parameter(torch.zeros(d))
        self.frame_pos = nn.Parameter(torch.zeros(n, d))
        self.frame_encoder = TransformerEncoder(cfg.temporal)
        self.linear = nn.Linear(d, e)
        self.linear2 = nn.Linear(e, cfg.aux_logit_dim)
        self.importance = nn.Linear(d, 1) if cfg.importance_head else None
        self.linearB = nn.Linear(d, e) if cfg.multi_task else None
        self.clip_cls = nn.Parameter(torch.zeros(d))
        self.clip_pos = nn.Parameter(torch.zeros(n, d))
        self.clip_encoder = TransformerEncoder(cfg.temporal)
        self.attentionA = nn.Linear(d, e)
        self.attentionB = nn.Linear(d, e)
        classes = [str(c) for c in range(cfg.n_attention_classes)]
        self.attention_modules = nn.ModuleDict(
            {c: nn.Linear(e, 1) for c in classes})
        self.final_modules = nn.ModuleDict(
            {c: nn.Linear(d, 1) for c in classes})
        self.cls_head = (nn.Linear(d, cfg.nclasses)
                         if cfg.data_type == "raw" else None)


class TemporalOutput(NamedTuple):
    full_seq: Optional[torch.Tensor]   # (B, S, F+1, D) post-ReLU encoder
    cls_seq: torch.Tensor    # (B, S, D); the frame mean without -sa
    # last layer's head-averaged attention: (B*S, F+1, F+1) on the dense
    # path, the CLS-query row (B*S, F+1) on the flash path (K2), the
    # reference's ones((1, 1)) placeholder without self-attention
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
    """prepareInputForTransformer + aggregateInputs (prepare_model.py:179-221).

    With cfg.self_attention=False (the reference CLI without -sa,
    prepare_model.py:296-301, 352-355) the encoder, positional embeddings
    and CLS token are skipped: the snippet track is a plain mean over the
    padded frame axis, pad rows included (the reference's torch.mean(x,
    2)), and the attention is the reference's ones((1, 1))."""
    if not cfg.self_attention:
        return TemporalOutput(None, reps.mean(dim=2),
                              torch.ones((1, 1), dtype=reps.dtype,
                                         device=reps.device))
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
    if cfg.importance_head and model.importance is not None \
            and full_seq is not None:
        importances = importance_scores(full_seq, model.importance)
    return PrototypesOutput(video_rep, aux_logits, attn, importances)


def _cls_head(model: FullModel) -> nn.Linear:
    if model.cls_head is None:
        raise KeyError(
            "cls_head: the model has no classification head; the JAX "
            "package's full_model_init makes it only for data_type 'raw' "
            "(sais_tpu/models/full_model.py:261), so -t ClassificationHead "
            "on stored reps fails at its first step there too")
    return model.cls_head


def classification_forward(model: FullModel, cfg: ModelConfig,
                           rgb: Optional[torch.Tensor] = None,
                           rgb_mask: Optional[torch.Tensor] = None,
                           flow: Optional[torch.Tensor] = None,
                           flow_mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """ClassificationHead task (prepare_model.py:423-440): single-modality,
    cls_head over the per-snippet CLS track (B, S, C); RGB-Flow, the two
    tracks summed, mean-pooled over snippets -> (B, C).  Raises KeyError
    when the model has no cls_head."""
    if cfg.modalities in ("RGB", "Flow"):
        x, m = (rgb, rgb_mask) if cfg.modalities == "RGB" else (flow,
                                                                 flow_mask)
        t = temporal_features(model, x, m, cfg)
        return _cls_head(model)(torch.relu(t.cls_seq))
    tr = temporal_features(model, rgb, rgb_mask, cfg)
    tf = temporal_features(model, flow, flow_mask, cfg)
    summed = tr.cls_seq + tf.cls_seq
    return _cls_head(model)(torch.relu(summed.mean(dim=1)))


def clip_reps(model: FullModel, snip_seq: torch.Tensor, cfg: ModelConfig
              ) -> torch.Tensor:
    """getClipReps (prepare_model.py:452-467): clip pos-embeddings + the
    clip encoder (unmasked, dense, as in JAX) + ReLU.  (B, S, D) ->
    (B, S, D)."""
    s = snip_seq.shape[1]
    x = snip_seq + model.clip_pos[:s].to(snip_seq.dtype)[None]
    out, _ = encoder_forward(model.clip_encoder, x, cfg.temporal, None)
    return torch.relu(out)


def mil_forward(model: FullModel, cfg: ModelConfig, rgb: torch.Tensor,
                rgb_mask: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[int, torch.Tensor]]:
    """MIL task (prepare_model.py:359-363): frame encoder -> clip encoder
    -> gated-attention MIL head.  Returns (logits (B, C), {class: attention
    (B, S)})."""
    t = temporal_features(model, rgb, rgb_mask, cfg)
    return mil_head(clip_reps(model, t.cls_seq, cfg), model, cfg.nclasses)


def full_model_init(generator: torch.Generator, cfg: ModelConfig
                    ) -> FullModel:
    """Random model on the CPU, as the reference (prepare_model.py:47-96):
    uniform [0, 1) CLS tokens and pos-embedding tables (torch.rand), torch
    Linear default init for the projections.  The Prototypes path's
    members are drawn first, the importance and linearB heads where the
    config has them next, and the clip and MIL members and cls_head last,
    so that a generator gives the Prototypes path the same weights
    whatever else the model holds."""
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
        model.clip_cls.copy_(torch.rand(model.clip_cls.shape,
                                        generator=generator))
        model.clip_pos.copy_(torch.rand(model.clip_pos.shape,
                                        generator=generator))
    encoder_init(model.clip_encoder, generator, cfg.temporal)
    with torch.no_grad():
        for lin in (model.attentionA, model.attentionB,
                    *model.attention_modules.values(),
                    *model.final_modules.values(), model.cls_head):
            if lin is not None:
                linear_(lin)
    return model


def prototypes_init(generator: torch.Generator, nclasses: int,
                    proj_dim: int = 256) -> Tuple[List[str], torch.Tensor]:
    """Fresh prototypes: keys '0'..'nclasses-1', uniform [0, 1) rows
    (prepare_model.py:555-560)."""
    return ([str(i) for i in range(nclasses)],
            torch.rand((nclasses, proj_dim), generator=generator))
