"""Copy detection (reference: dino-main/eval_copy_detection.py;
counterpart of `sais_tpu/eval/copy_detection.py`).

- descriptors: the [CLS] token concatenated with GeM (p = 4) pooled patch
  tokens (eval_copy_detection.py:165-175), from the float32 ViT on the
  model's device;
- PCA whitening (whit = 0.5) trained on a held-out image set
  (eval_copy_detection.py:271-286, utils.py:655-705);
- cosine ranking and the Holidays trapezoid AP (score_ap_from_ranks_1,
  eval_copy_detection.py:97-126).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from sais_tpu_torch.models.vit import VisionTransformer, vit_tokens


def copy_detection_features(model: VisionTransformer, images: torch.Tensor,
                            gem_p: float = 4.0) -> torch.Tensor:
    """(B, H, W, 3) normalized images -> (B, 2D) [CLS | GeM of the patch
    tokens] (eval_copy_detection.py:165-175)."""
    with torch.inference_mode():
        toks = vit_tokens(model, images)              # (B, 1 + N, D)
        patches = toks[:, 1:].clamp(min=1e-6)
        gem = (patches ** gem_p).mean(dim=1) ** (1.0 / gem_p)
        return torch.cat([toks[:, 0], gem], dim=-1)


class PCAWhitening:
    """utils.PCA (dino-main/utils.py:655-705): eigendecomposition of the
    features' second moment, eigenvalues to the power -whit, optional
    reduction to `dim` components."""

    def __init__(self, dim: int, whit: float = 0.5):
        self.dim = dim
        self.whit = whit
        self.dvt: Optional[np.ndarray] = None

    def train(self, feats: np.ndarray) -> "PCAWhitening":
        cov = feats.T @ feats / feats.shape[0]
        d, v = np.linalg.eigh(cov)
        eps = d.max() * 1e-5
        d[d < eps] = eps
        idx = np.argsort(d)[::-1][:self.dim]
        d, v = d[idx], v[:, idx]
        self.dvt = np.diag(1.0 / d ** self.whit) @ v.T
        return self

    def apply(self, x: np.ndarray) -> np.ndarray:
        return (self.dvt @ x.T).T


def whiten_and_normalize(queries: np.ndarray, database: np.ndarray,
                         whitening_feats: Optional[np.ndarray] = None
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Centre on the whitening set's mean, whiten, l2-normalize
    (eval_copy_detection.py:271-292).  As the reference does, the PCA
    reads the uncentred second moment of the whitening features (:283)
    while queries and database are centred on their mean."""
    if whitening_feats is not None:
        mean = whitening_feats.mean(axis=0)
        queries = queries - mean
        database = database - mean
        pca = PCAWhitening(dim=database.shape[-1]).train(whitening_feats)
        queries = pca.apply(queries)
        database = pca.apply(database)
    qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    dn = database / np.linalg.norm(database, axis=1, keepdims=True)
    return qn, dn


def similarity(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b.T in float32 (the rankings' one product)."""
    return (torch.from_numpy(np.ascontiguousarray(a, np.float32))
            @ torch.from_numpy(np.ascontiguousarray(b, np.float32)).T
            ).numpy()


def rank_copies(queries: np.ndarray, database: np.ndarray,
                topk: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Cosine-similarity ranking (eval_copy_detection.py:294-299):
    (similarities, indices), every database entry ranked, as the
    reference's untruncated argsort (an AP integrates every positive's
    rank); `topk` only for nearest-neighbour dumps."""
    sim = similarity(queries, database)
    idx = np.argsort(-sim, axis=1)
    if topk is not None:
        idx = idx[:, :topk]
    return np.take_along_axis(sim, idx, axis=1), idx


def score_ap_from_ranks(ranks: Sequence[int], nres: int) -> float:
    """Holidays AP (score_ap_from_ranks_1, eval_copy_detection.py:97-126)."""
    ap = 0.0
    recall_step = 1.0 / nres
    for ntp, rank in enumerate(ranks):
        precision_0 = 1.0 if rank == 0 else ntp / float(rank)
        precision_1 = (ntp + 1) / float(rank + 1)
        ap += (precision_1 + precision_0) * recall_step / 2.0
    return ap


def copydays_block_map(indices: np.ndarray,
                       positives_per_query: List[List[int]]) -> float:
    """mAP of one Copydays block (eval_result, eval_copy_detection.py
    :63-93): the positions of the true positives in each ranked list ->
    AP."""
    total = 0.0
    for qno, row in enumerate(indices):
        positives = positives_per_query[qno]
        ranks = [rank for rank, bno in enumerate(row) if bno in positives]
        total += score_ap_from_ranks(ranks, len(positives))
    return total / len(indices)
