"""Prototype head: cosine similarity to prototypes, softmax, entropy, the
NCE training loss and the label -> prototype column rule, and the
per-frame importance head.

Counterpart of the Prototypes and importance parts of
`sais_tpu/models/heads.py` (prepare_miscellaneous.py:14-46, :97-161,
process_inference_results.py:76-91,131, prepare_model.py:419-421).  The
MIL head waits for the classification slice.
"""

from __future__ import annotations

from typing import Any, Sequence

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


def importance_scores(full_seq: torch.Tensor, importance: torch.nn.Linear
                      ) -> torch.Tensor:
    """Per-frame importance logits (prepare_model.py:419-421):
    full_seq (B, S, F+1, D) -> (B, S, F+1, 1), CLS slot included as in the
    reference."""
    return importance(full_seq)
