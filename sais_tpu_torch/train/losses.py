"""Training losses (reference: prepare_miscellaneous.py).

Counterpart of `sais_tpu/train/losses.py`:

- the NCE prototype loss lives in `models.heads` (shared with inference);
- `importance_loss_reference` replicates calcImportanceLoss (:48-60)
  INCLUDING its broadcast quirk: the elementwise BCE is reduced to a scalar
  FIRST, then multiplied by the inverted pad mask and averaged over
  low-skill rows — so the result equals mean_BCE * mean(valid_mask over
  low-skill rows), and every row's scores get a gradient, padded and
  high-skill rows included.  The reference's checkpoints were trained with
  this objective, so it is kept verbatim; `masked_importance_loss` is the
  corrected masked BCE for new training runs.

- cross-entropy / BCE for the MIL and ClassificationHead tasks, the
  next-representation MSE and the arrow-of-time pair (:62-95, :212-248).
"""

from __future__ import annotations

from typing import Optional

import torch


def _bce_with_logits(logits: torch.Tensor, targets: torch.Tensor
                     ) -> torch.Tensor:
    """Elementwise BCEWithLogits, in the numerically stable form torch and
    the JAX package use."""
    return (torch.clamp(logits, min=0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def importance_loss_reference(output_importances: torch.Tensor,
                              importances: torch.Tensor,
                              ipad: torch.Tensor,
                              labels: torch.Tensor,
                              weight: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """calcImportanceLoss (prepare_miscellaneous.py:48-60), quirk preserved.

    output_importances: (B, S, F+1, 1) model scores (CLS at slot 0);
    importances: (B, S, F) per-frame targets; ipad: (B, S, F+1) bool pad
    mask; labels: (B,) int — only label==0 (low skill) rows contribute.
    weight: optional (B,) 0/1 real-row mask (padded batches) — the quirky
    global BCE mean then averages over REAL rows only.

    Without a low-skill row the loss is 0, as in the JAX package, and so
    is its gradient (JAX's is NaN there: the 0 / 0 of the jnp.where branch
    it does not select)."""
    scores = output_importances[:, :, 1:, 0]                  # (B, S, F)
    bce = _bce_with_logits(scores, importances)
    if weight is not None:
        w = weight.to(bce.dtype)[:, None, None]
        scalar = (bce * w).sum() / torch.clamp(
            w.sum() * bce.shape[1] * bce.shape[2], min=1.0)
    else:
        scalar = bce.mean()                                   # the quirk
    inv = (~ipad)[:, :, :-1].to(bce.dtype)                    # (B, S, F)
    low = (labels == 0).to(bce.dtype)                         # (B,)
    denom = low.sum() * inv.shape[1] * inv.shape[2]
    total = (scalar * inv * low[:, None, None]).sum()
    return torch.where(denom > 0, total / torch.clamp(denom, min=1.0),
                       torch.zeros_like(total))


def masked_importance_loss(output_importances: torch.Tensor,
                           importances: torch.Tensor, ipad: torch.Tensor,
                           labels: torch.Tensor) -> torch.Tensor:
    """The loss the reference *intended*: per-frame BCE masked to valid
    frames of low-skill rows.  Use for new training runs."""
    scores = output_importances[:, :, 1:, 0]
    bce = _bce_with_logits(scores, importances)
    valid = (~ipad)[:, :, :-1].to(bce.dtype)
    low = (labels == 0).to(bce.dtype)[:, None, None]
    w = valid * low
    return (bce * w).sum() / torch.clamp(w.sum(), min=1.0)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """nn.CrossEntropyLoss mean reduction (prepare_miscellaneous.py:75-76)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels.long()[:, None])[:, 0].mean()


def binary_cross_entropy_logits(logits: torch.Tensor, labels: torch.Tensor
                                ) -> torch.Tensor:
    """nn.BCEWithLogitsLoss mean reduction (nclasses == 1 path,
    perform_training.py:139-141)."""
    return _bce_with_logits(logits.reshape(-1),
                            labels.to(logits.dtype).reshape(-1)).mean()


def next_rep_mse(future_reps: torch.Tensor, snip_reps: torch.Tensor
                 ) -> torch.Tensor:
    """Self-supervised next-representation MSE (calcSSLoss,
    prepare_miscellaneous.py:85-95)."""
    return (snip_reps[:, :-1, :] - future_reps[:, 1:, :]).square().mean()


def temporal_coherence_loss(logits: torch.Tensor,
                            logits_flipped: torch.Tensor) -> torch.Tensor:
    """Arrow-of-time pretext loss (calcTemporalCoherenceLoss,
    prepare_miscellaneous.py:212-229): CE toward class 0 for forward clips
    and class 1 for time-reversed clips, averaged."""
    la = cross_entropy(logits, torch.zeros(logits.shape[0],
                                           dtype=torch.long,
                                           device=logits.device))
    lb = cross_entropy(logits_flipped,
                       torch.ones(logits_flipped.shape[0], dtype=torch.long,
                                  device=logits.device))
    return (la + lb) / 2.0


def temporal_coherence_accuracy(logits: torch.Tensor,
                                logits_flipped: torch.Tensor
                                ) -> torch.Tensor:
    """calcTemporalCoherenceAcc (prepare_miscellaneous.py:231-248)."""
    a = (logits.argmax(-1) == 0).sum()
    b = (logits_flipped.argmax(-1) == 1).sum()
    return (a + b) / (logits.shape[0] + logits_flipped.shape[0])
