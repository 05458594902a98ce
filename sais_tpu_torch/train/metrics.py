"""Epoch metrics (reference: prepare_miscellaneous.py:97-208).

Own copy of `sais_tpu/train/metrics.py` in numpy, without sklearn (the card's machine has none).  The same quantities as
sklearn computes them there: accuracy; macro precision and recall over
the labels present in either the truth or the predictions, with
zero_division=0; ROC-AUC (roc_auc_score(multi_class='ovr')): binary on
probs[:, -1] for two prototypes, one-vs-rest macro for more, with tied
scores given average ranks, and NaN wherever sklearn raises (one class
present, a class count that differs from the number of columns, rows that
are not probabilities, non-finite scores), as the reference's try/except
gives (:156-159).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from sais_tpu_torch.models.heads import labels_to_prototype_columns


def _average_ranks(x: np.ndarray) -> np.ndarray:
    """1-based ranks of x, ties sharing the mean of their ranks."""
    order = np.argsort(x, kind="mergesort")
    xs = x[order]
    first = np.r_[True, xs[1:] != xs[:-1]]
    group = np.cumsum(first) - 1
    starts = np.flatnonzero(first)
    ends = np.r_[starts[1:], len(x)]
    mean_rank = (starts + ends + 1) / 2.0
    ranks = np.empty(len(x))
    ranks[order] = mean_rank[group]
    return ranks


def binary_auc(positive: np.ndarray, scores: np.ndarray) -> float:
    """Area under the ROC curve of boolean labels against scores (the
    Mann-Whitney statistic, ties counting one half); NaN when only one
    class is present."""
    n_pos = int(positive.sum())
    n_neg = len(positive) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    r = _average_ranks(scores)[positive].sum()
    return float((r - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def roc_auc(labels: np.ndarray, probs: np.ndarray, nclasses: int) -> float:
    if not np.isfinite(probs).all():
        return float("nan")
    if nclasses == 2:
        return binary_auc(labels == labels.max(), probs[:, -1])
    classes = np.unique(labels)
    if len(classes) != probs.shape[1] \
            or not np.allclose(1, probs.sum(axis=1)):
        return float("nan")
    return float(np.mean([binary_auc(labels == c, probs[:, i])
                          for i, c in enumerate(classes)]))


def _scores(labels: np.ndarray, preds: np.ndarray, probs: np.ndarray,
            nclasses: int) -> Dict[str, float]:
    present = np.union1d(labels, preds)
    prec, rec = [], []
    for c in present:
        tp = float(np.sum((preds == c) & (labels == c)))
        npred, ntrue = np.sum(preds == c), np.sum(labels == c)
        prec.append(tp / npred if npred else 0.0)
        rec.append(tp / ntrue if ntrue else 0.0)
    return {"acc": float(np.mean(preds == labels)),
            "auc": roc_auc(labels, probs, nclasses),
            "precision": float(np.mean(prec)),
            "recall": float(np.mean(rec))}


def prototype_metrics(tta_probs: Sequence[np.ndarray], labels: Sequence,
                      prototype_keys: Sequence[str]) -> Dict[str, float]:
    """calcNCEMetrics: mean probabilities over TTA augments, argmax
    predictions, label columns by the string-matching rule."""
    probs = np.mean(np.stack(tta_probs, 0), 0)
    cols = labels_to_prototype_columns(labels, prototype_keys)
    return _scores(cols, np.argmax(probs, axis=1), probs,
                   len(prototype_keys))


def logits_metrics(tta_logits: Sequence[np.ndarray], labels: np.ndarray,
                   nclasses: int) -> Dict[str, float]:
    """calcMetrics: mean logits over TTA augments, then sigmoid (one class)
    or softmax probabilities and their predictions."""
    logits = np.mean(np.stack(tta_logits, 0), 0)
    labels = np.asarray(labels)
    if nclasses == 1:
        probs = 1.0 / (1.0 + np.exp(-logits))
        preds = (probs > 0.5).astype(np.int64).reshape(-1)
        return _scores(labels, preds,
                       np.concatenate([1 - probs, probs], axis=-1), 2)
    z = logits - logits.max(axis=-1, keepdims=True)
    probs = np.exp(z) / np.exp(z).sum(axis=-1, keepdims=True)
    return _scores(labels, np.argmax(probs, axis=1), probs, nclasses)


def format_metrics(phase: str, metrics: Dict[str, float]) -> str:
    """printMetrics-style single-row table (prepare_miscellaneous.py:197-203)."""
    names = [f"{phase}_{k}" for k in metrics]
    vals = [f"{v:.3f}" for v in metrics.values()]
    w = [max(len(a), len(b)) for a, b in zip(names, vals)]
    line1 = "  ".join(n.ljust(x) for n, x in zip(names, w))
    line2 = "  ".join(v.ljust(x) for v, x in zip(vals, w))
    return line1 + "\n" + line2


class MetricsTracker:
    """trackMetrics (prepare_miscellaneous.py:205-208): append-per-epoch."""

    def __init__(self):
        self.history: Dict[str, List[float]] = {}

    def update(self, metrics: Dict[str, float]) -> None:
        for k, v in metrics.items():
            self.history.setdefault(k, []).append(v)
