"""Classification heads: the prototype head (cosine similarity to
prototypes, softmax, entropy, the NCE training loss and the label ->
prototype column rule), the gated-attention MIL head and the per-frame
importance head.

Counterpart of `sais_tpu/models/heads.py` (prepare_miscellaneous.py:14-46,
:97-161, process_inference_results.py:76-91,131, prepare_model.py:131-148,
:419-421, :469-488).
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch


def _l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    # the reference divides by the plain L2 norm with no epsilon
    # (prepare_miscellaneous.py:17,26)
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True)


def prototype_similarities(video_reps: torch.Tensor,
                           prototypes: torch.Tensor) -> torch.Tensor:
    """Cosine similarity: video_reps (B, D), prototypes (P, D) -> (B, P)."""
    s = _l2_normalize(video_reps.float())
    p = _l2_normalize(prototypes.float())
    return torch.matmul(s, p.t())


def prototype_probs(video_reps: torch.Tensor,
                    prototypes: torch.Tensor) -> torch.Tensor:
    """exp(sim) / sum(exp(sim)), a softmax over prototypes
    (process_inference_results.py:88-91)."""
    return torch.softmax(prototype_similarities(video_reps, prototypes), -1)


def labels_to_prototype_columns(labels: Sequence[Any],
                                prototype_keys: Sequence[str]) -> np.ndarray:
    """String-match labels to prototype columns, keeping the reference's
    argmax quirk: a label that matches no key maps to column 0
    (prepare_miscellaneous.py:32-37)."""
    keys = list(prototype_keys)
    return np.asarray([keys.index(str(lab)) if str(lab) in keys else 0
                       for lab in labels], dtype=np.int32)


def nce_loss(video_reps: torch.Tensor, prototypes: torch.Tensor,
             label_cols: torch.Tensor) -> torch.Tensor:
    """Temperature-free cosine InfoNCE against the prototypes
    (prepare_miscellaneous.py:14-46): -mean(log softmax(sim)[i, col_i])."""
    logp = torch.log_softmax(prototype_similarities(video_reps, prototypes),
                             -1)
    return -logp.gather(1, label_cols.long()[:, None])[:, 0].mean()


def entropy(probs: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Prediction entropy -sum(p log p) (process_inference_results.py:131)."""
    return -(probs * torch.log(probs)).sum(dim)


def gated_attention_pool(snip_reps: torch.Tensor, model, category: str
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gated-attention MIL pooling for one class (prepare_model.py:131-143):
    softmax over snippets of w_c(tanh(A x) * sigmoid(B x)), then the
    attention-weighted snippet mean.  model: a FullModel (attentionA,
    attentionB, attention_modules).  snip_reps (B, S, D) -> (video_rep
    (B, D), attention (B, S))."""
    gated = (torch.tanh(model.attentionA(snip_reps))
             * torch.sigmoid(model.attentionB(snip_reps)))      # (B, S, E)
    scores = model.attention_modules[category](gated)          # (B, S, 1)
    attn = torch.softmax(scores, dim=1)[..., 0]                 # (B, S)
    return torch.einsum("bs,bsd->bd", attn, snip_reps), attn


def mil_head(snip_reps: torch.Tensor, model, nclasses: int
             ) -> Tuple[torch.Tensor, Dict[int, torch.Tensor]]:
    """Attention-based MIL head (prepare_model.py:469-488): per class c,
    gated-attention pooling and final_modules[c] -> one logit.
    snip_reps (B, S, D) -> (logits (B, nclasses), {class: attention
    (B, S)}).  Raises ValueError for more classes than per-class modules,
    as the JAX package does."""
    n_modules = len(model.final_modules)
    if nclasses > n_modules:
        raise ValueError(
            f"MIL head has {n_modules} per-class modules "
            f"(ModelConfig.n_attention_classes) but nclasses={nclasses}; "
            "raise n_attention_classes to at least nclasses "
            "(the reference hardcodes 3, prepare_model.py:88-91)")
    scores, attention = [], {}
    for c in range(nclasses):
        video_rep, attn = gated_attention_pool(snip_reps, model, str(c))
        scores.append(model.final_modules[str(c)](video_rep))   # (B, 1)
        attention[c] = attn
    return torch.cat(scores, dim=1), attention


def importance_scores(full_seq: torch.Tensor, importance: torch.nn.Linear
                      ) -> torch.Tensor:
    """Per-frame importance logits (prepare_model.py:419-421):
    full_seq (B, S, F+1, D) -> (B, S, F+1, 1), CLS slot included as in the
    reference."""
    return importance(full_seq)
