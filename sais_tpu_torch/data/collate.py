"""Batch collation: ragged labeled segments -> padded arrays.

Own copy of `sais_tpu/data/collate.py` without pandas.  The reference
pad_collate (prepare_dataset.py:2808-2935) pads each batch to its longest
segment; the JAX package rounds that length up to a bucket (16, 32, 64,
128; the flow rows also 2, 4, 8), and the port keeps the buckets so that
both packages see the same arrays.  Mask semantics: mask[i, :, len_i + 1:]
= True, slot 0 the always-valid CLS (createPaddingMask,
prepare_dataset.py:2798-2806).  A segment's flow rows are the unique
frame_index // flow_jump rows below the store's length
(`windows.flow_indices_for`), sorted, so the flow mask is a suffix after
the CLS slot; a segment with none gets one zero row, masked.  The skill path's collation is `data/skill.py`.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from sais_tpu_torch.config import WindowConfig
from sais_tpu_torch.data.datasets import CachingStore, Row, batched_indices
from sais_tpu_torch.data.windows import flow_indices_for, segment_frame_indices

BUCKETS = (16, 32, 64, 128)


def bucket_for(n: int, buckets: Sequence[int] = BUCKETS) -> int:
    """The first bucket that holds n frames; raises past the last."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"length {n} exceeds largest bucket {buckets[-1]}")


def collate_segments(rows: Sequence[Row], rgb_store,
                     label_to_col: Dict[Any, int], wcfg: WindowConfig,
                     tta_offset: int = 0, flow_store=None,
                     fixed_stride: Optional[int] = None,
                     cap: Optional[int] = None,
                     label_fn: Optional[Callable[[Row], int]] = None,
                     buckets: Sequence[int] = BUCKETS
                     ) -> Dict[str, np.ndarray]:
    """One batch from segment rows (Video / StartFrame / EndFrame /
    Gesture); the stores have read_video(name) -> (N, D).  Returns the
    batch dict the trainers consume: rgb (B, 1, F, D) f32, rgb_mask
    (B, 1, F + 1) bool, label_cols and labels (B,) int32 (the Gesture's
    column, or label_fn(row)), and, with a flow store, flow (B, 1, Ff, D)
    and flow_mask (B, 1, Ff + 1).  RGB is always gathered, as in the JAX
    package.  fixed_stride / cap go to `segment_frame_indices`; F is the
    first of `buckets` that holds the longest segment."""
    feats: List[np.ndarray] = []
    flows: List[np.ndarray] = []
    flow_valid: List[np.ndarray] = []
    cols: List[int] = []
    for row in rows:
        reps = rgb_store.read_video(row["Video"])
        idx = segment_frame_indices(int(row["StartFrame"]),
                                    int(row["EndFrame"]), wcfg, tta_offset,
                                    fixed_stride=fixed_stride, cap=cap)
        feats.append(reps[idx])
        if flow_store is not None:
            freps = flow_store.read_video(row["Video"])
            fidx, fvalid = flow_indices_for(idx[None], len(freps), wcfg)
            flows.append(freps[fidx[0]] * fvalid[0][:, None])
            flow_valid.append(fvalid[0])
        cols.append(label_fn(row) if label_fn is not None
                    else label_to_col[row["Gesture"]])
    b, d = len(feats), feats[0].shape[1]
    fb = bucket_for(max(len(x) for x in feats), buckets)
    rgb = np.zeros((b, 1, fb, d), np.float32)
    rgb_mask = np.zeros((b, 1, fb + 1), bool)
    for i, x in enumerate(feats):
        rgb[i, 0, :len(x)] = x
        rgb_mask[i, 0, len(x) + 1:] = True
    batch = {"rgb": rgb, "rgb_mask": rgb_mask,
             "label_cols": np.asarray(cols, np.int32),
             "labels": np.asarray(cols, np.int32)}
    if flows:
        ff = bucket_for(max(len(x) for x in flows), [2, 4, 8, 16, *buckets])
        flow = np.zeros((b, 1, ff, flows[0].shape[1]), np.float32)
        flow_mask = np.zeros((b, 1, ff + 1), bool)
        for i, (x, valid) in enumerate(zip(flows, flow_valid)):
            flow[i, 0, :len(x)] = x
            flow_mask[i, 0, 1:len(x) + 1] = ~valid
            flow_mask[i, 0, len(x) + 1:] = True
        batch["flow"] = flow
        batch["flow_mask"] = flow_mask
    return batch


def segment_batches(rows: Sequence[Row], rgb_store, classes: Sequence,
                    wcfg: WindowConfig, batch_size: int, shuffle: bool,
                    seed: int = 0, tta: bool = False, flow_store=None,
                    fixed_stride: Optional[int] = None,
                    cap: Optional[int] = None,
                    label_fn: Optional[Callable[[Row], int]] = None,
                    buckets: Sequence[int] = BUCKETS
                    ) -> Iterator[Dict[str, Any]]:
    """Collated batches over a phase's segment rows.  tta=True (val / test)
    attaches the reference's 3-way TTA variants (offsets +0 / +3 / +6,
    prepare_dataset.py:2645-2656) under a 'tta' key; the trainers mean
    losses and probabilities (or logits) over them
    (perform_training.py:126-149).  The other arguments go to
    `collate_segments`."""
    label_to_col = {c: i for i, c in enumerate(classes)}
    offsets = tuple(wcfg.tta_offsets) if tta else (0,)
    for idx in batched_indices(len(rows), batch_size, shuffle, seed):
        # one read per distinct video per batch, shared by the variants
        store = CachingStore(rgb_store)
        flows = CachingStore(flow_store) if flow_store is not None else None
        picked = [rows[i] for i in idx]
        variants = [collate_segments(
            picked, store, label_to_col, wcfg, tta_offset=off,
            flow_store=flows, fixed_stride=fixed_stride, cap=cap,
            label_fn=label_fn, buckets=buckets) for off in offsets]
        out = dict(variants[0])
        if tta:
            out["tta"] = variants
        yield out
