"""Prototype head: cosine similarity to prototypes, softmax, entropy.

Counterpart of the inference half of `sais_tpu/models/heads.py`
(prepare_miscellaneous.py:14-46, process_inference_results.py:76-91,131).
The MIL head and the NCE loss wait for the training slice.
"""

from __future__ import annotations

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


def entropy(probs: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Prediction entropy -sum(p log p) (process_inference_results.py:131)."""
    return -(probs * torch.log(probs)).sum(dim)
