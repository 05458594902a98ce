"""DAVIS-style video segmentation by label propagation (reference:
dino-main/eval_video_segmentation.py; counterpart of
`sais_tpu/eval/video_segmentation.py`).

Per-frame patch features drive a nearest-neighbour propagation of labels
from a queue of context frames (the first frame and the n most recent):

- affinity exp(cos-sim / 0.1) between the target's patch queries and the
  context's keys (label_propagation, eval_video_segmentation.py:113-150);
- optionally restricted to a spatial neighbourhood (restrict_neighborhood,
  :85-99);
- top-k over the source axis, normalization, product with the context's
  soft one-hot masks;
- per-channel min-max renormalization (norm_mask, :102-110).

Each step's products run on the model's device.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from sais_tpu_torch.models.vit import VisionTransformer, vit_tokens


def patch_features(model: VisionTransformer, frame: torch.Tensor
                   ) -> Tuple[torch.Tensor, int, int]:
    """(H, W, 3) normalized frame -> ((h * w, D) patch features, h, w)
    (extract_feature, eval_video_segmentation.py:153-163)."""
    with torch.inference_mode():
        toks = vit_tokens(model, frame[None])[0, 1:]
    patch = model.cfg.patch_size
    return toks, frame.shape[0] // patch, frame.shape[1] // patch


def restrict_neighborhood(h: int, w: int, size: int) -> np.ndarray:
    """(h * w, h * w) 0 / 1 mask of the source nodes within a (2 size +
    1)^2 window of each query node (restrict_neighborhood,
    eval_video_segmentation.py:85-99)."""
    qi, qj = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    si, sj = qi.reshape(-1), qj.reshape(-1)
    di = np.abs(si[:, None] - si[None, :])
    dj = np.abs(sj[:, None] - sj[None, :])
    return ((di <= size) & (dj <= size)).astype(np.float32)


def norm_mask(mask: np.ndarray) -> np.ndarray:
    """Per-channel min-max renormalization (norm_mask, :102-110)."""
    out = mask.copy()
    for c in range(mask.shape[0]):
        m = out[c]
        if m.max() > 0:
            m = m - m.min()
            out[c] = m / m.max()
    return out


def _propagate(feat_tar: torch.Tensor, feat_sources: torch.Tensor,
               segs: torch.Tensor, mask: Optional[torch.Tensor], topk: int,
               temperature: float) -> torch.Tensor:
    """One propagation step.  feat_tar (hw, D); feat_sources (n, hw, D);
    segs (n, C, hw); mask (hw, hw) or None -> (C, hw)."""
    ft = feat_tar / torch.linalg.vector_norm(feat_tar, dim=1, keepdim=True)
    fs = feat_sources / torch.linalg.vector_norm(feat_sources, dim=2,
                                                 keepdim=True)
    aff = torch.exp(torch.einsum("qd,nkd->nqk", ft, fs) / temperature)
    if mask is not None:
        aff = aff * mask[None]
    n, hw_q, hw_k = aff.shape
    # the reference reshapes to (n * hw_k, hw_q) and takes the top k over
    # the sources
    aff = aff.permute(0, 2, 1).reshape(n * hw_k, hw_q)
    kth = torch.topk(aff.T, topk, dim=1).values[:, -1]
    aff = torch.where(aff < kth[None, :], torch.zeros_like(aff), aff)
    aff = aff / aff.sum(dim=0, keepdim=True)
    c = segs.shape[1]
    seg_flat = segs.permute(0, 2, 1).reshape(n * hw_k, c).T   # (C, n hw)
    return seg_flat @ aff                                      # (C, hw_q)


def label_propagation(model: VisionTransformer, frame_tar: torch.Tensor,
                      context_feats: List[torch.Tensor],
                      context_segs: List[np.ndarray],
                      topk: int = 5, temperature: float = 0.1,
                      neighborhood: int = 12,
                      mask: Optional[np.ndarray] = None
                      ) -> Tuple[np.ndarray, torch.Tensor, np.ndarray]:
    """The context's masks propagated to the target frame
    (label_propagation, eval_video_segmentation.py:113-150).
    context_segs: (C, h, w) soft one-hot masks.  Returns (the target's
    mask (C, h, w), its patch features, the neighbourhood mask)."""
    feat_tar, h, w = patch_features(model, frame_tar)
    if neighborhood > 0 and mask is None:
        mask = restrict_neighborhood(h, w, neighborhood)
    dev = feat_tar.device
    with torch.inference_mode():
        seg = _propagate(
            feat_tar, torch.stack(context_feats),
            torch.stack([torch.as_tensor(s.reshape(s.shape[0], -1),
                                         dtype=torch.float32, device=dev)
                         for s in context_segs]),
            None if mask is None else torch.as_tensor(mask, device=dev),
            topk, temperature)
    return seg.cpu().numpy().reshape(-1, h, w), feat_tar, mask


def track_video(model: VisionTransformer, frames: np.ndarray,
                first_seg: np.ndarray, n_last_frames: int = 7,
                topk: int = 5, neighborhood: int = 12,
                temperature: float = 0.1) -> List[np.ndarray]:
    """eval_video_tracking_davis's queue (:38-82): the first frame and the
    n most recent (frame, mask) pairs form the context; the propagated
    masks are fed back raw (the reference copies them before norm_mask,
    :70-75) and returned renormalized.  frames: (T, H, W, 3) normalized;
    first_seg: (C, h, w) one-hot.  Returns the (C, h, w) masks of frames
    1 .. T - 1."""
    dev = model.cls_token.device

    def frame(t):
        return torch.as_tensor(frames[t], dtype=torch.float32, device=dev)

    feat0, _, _ = patch_features(model, frame(0))
    que: List[Tuple[torch.Tensor, np.ndarray]] = []
    mask = None
    out = []
    for t in range(1, len(frames)):
        seg, feat_tar, mask = label_propagation(
            model, frame(t), [feat0] + [f for f, _ in que],
            [first_seg] + [s for _, s in que], topk=topk,
            temperature=temperature, neighborhood=neighborhood, mask=mask)
        que.append((feat_tar, seg))
        if len(que) > n_last_frames:
            que.pop(0)
        out.append(norm_mask(seg))
    return out


def to_one_hot(labels: np.ndarray, n_classes: Optional[int] = None
               ) -> np.ndarray:
    """(h, w) int labels -> (C, h, w) one-hot (to_one_hot, :176-188)."""
    n = int(n_classes if n_classes is not None else labels.max() + 1)
    return np.eye(n, dtype=np.float32)[labels].transpose(2, 0, 1)
