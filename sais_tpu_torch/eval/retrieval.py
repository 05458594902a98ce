"""Image retrieval evaluation (reference: dino-main/eval_image_retrieval.py
and utils.compute_map / multi_scale; counterpart of
`sais_tpu/eval/retrieval.py`).

- multi-scale descriptors: CLS features at scales 1, 1/sqrt(2) and 1/2,
  summed, divided by 3 and by each one's norm (utils.py multi_scale);
- ranking by the cosine similarity of l2-normalized features
  (eval_image_retrieval.py:170-178);
- the revisited Oxford / Paris mAP with junk removal and precision@k
  (utils.compute_ap / compute_map, utils.py:709-812): the medium protocol
  scores easy and hard positives, the hard one hard positives with the
  easy ones junked (eval_image_retrieval.py:180-196).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from sais_tpu_torch.eval.copy_detection import (score_ap_from_ranks,
                                                similarity)
from sais_tpu_torch.models.vit import VisionTransformer, vit_features


def _resize_weights(n_in: int, n_out: int) -> torch.Tensor:
    """(n_in, n_out) weights of jax.image.resize's "bilinear" along one axis
    (scale_and_translate with a triangle kernel, widened by n_in / n_out
    when downsampling: antialiased), which the JAX package's multi_scale
    resizes with."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in)[:, None]) / kernel_scale
    w = np.maximum(0.0, 1.0 - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.from_numpy(np.where(inside[None, :], w, 0.0).astype(
        np.float32))


def resize_bilinear(images: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, h, w, C), jax.image.resize(method="bilinear")."""
    wh = _resize_weights(images.shape[1], h).to(images.device)
    ww = _resize_weights(images.shape[2], w).to(images.device)
    return torch.einsum("bhwc,hi,wj->bijc", images.float(), wh, ww)


def multi_scale_features(model: VisionTransformer, images: torch.Tensor
                         ) -> torch.Tensor:
    """utils.multi_scale: CLS features at 3 scales, averaged, then divided
    by each descriptor's own norm (the reference runs batch size 1).
    images: (B, H, W, 3) normalized, the model's device."""
    patch = model.cfg.patch_size
    _, h, w, _ = images.shape
    v = None
    with torch.inference_mode():
        for s in (1.0, 2 ** -0.5, 0.5):
            inp = images
            if s != 1.0:
                nh, nw = int(h * s), int(w * s)
                nh -= nh % patch    # whole patches, as the reference feeds
                nw -= nw % patch
                inp = resize_bilinear(images, nh, nw)
            feats = vit_features(model, inp)
            v = feats if v is None else v + feats
        v = v / 3.0
        return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def retrieval_ranks(db_features: np.ndarray,
                    query_features: np.ndarray) -> np.ndarray:
    """l2-normalize both sides, similarity, descending ranks
    (eval_image_retrieval.py:170-178): (n_db, n_q) rank matrix."""
    dbn = db_features / np.linalg.norm(db_features, axis=1, keepdims=True)
    qn = query_features / np.linalg.norm(query_features, axis=1,
                                         keepdims=True)
    return np.argsort(-similarity(dbn, qn), axis=0)


# utils.compute_ap (utils.py:709-741) is the same trapezoid AP as the
# copy-detection protocol's score_ap_from_ranks_1
compute_ap = score_ap_from_ranks


def compute_map(ranks: np.ndarray, gnd: Sequence[Dict],
                kappas: Sequence[int] = ()) -> Tuple[float, np.ndarray,
                                                     np.ndarray, np.ndarray]:
    """utils.compute_map (utils.py:744-812): junk-corrected mAP, per-query
    APs, mean precision@k and per-query precision@k."""
    mean_ap = 0.0
    nq = len(gnd)
    aps = np.zeros(nq)
    pr = np.zeros(len(kappas))
    prs = np.zeros((nq, len(kappas)))
    nempty = 0
    for i in range(nq):
        qgnd = np.array(gnd[i]["ok"])
        if qgnd.shape[0] == 0:
            aps[i] = float("nan")
            prs[i, :] = float("nan")
            nempty += 1
            continue
        qgndj = np.array(gnd[i].get("junk", []))
        pos = np.arange(ranks.shape[0])[np.isin(ranks[:, i], qgnd)]
        junk = np.arange(ranks.shape[0])[np.isin(ranks[:, i], qgndj)]
        if len(junk):
            # each positive's rank moves down by the junk ranked above it
            k = ij = ip = 0
            while ip < len(pos):
                while ij < len(junk) and pos[ip] > junk[ij]:
                    k += 1
                    ij += 1
                pos[ip] = pos[ip] - k
                ip += 1
        ap = compute_ap(pos, len(qgnd))
        mean_ap += ap
        aps[i] = ap
        pos = pos + 1  # 1-based for P@k
        for j, kappa in enumerate(kappas):
            kq = min(max(pos), kappa)
            prs[i, j] = (pos <= kq).sum() / kq
        pr = pr + prs[i, :]
    denom = max(nq - nempty, 1)
    return mean_ap / denom, aps, pr / denom, prs


def revisited_protocols(gnd: Sequence[Dict]) -> Dict[str, List[Dict]]:
    """The medium and hard ground truths (eval_image_retrieval.py:180-193)."""
    medium = [{"ok": np.concatenate([g["easy"], g["hard"]]),
               "junk": np.concatenate([g["junk"]])} for g in gnd]
    hard = [{"ok": np.concatenate([g["hard"]]),
             "junk": np.concatenate([g["junk"], g["easy"]])} for g in gnd]
    return {"medium": medium, "hard": hard}
