"""Batch collation: ragged labeled segments -> padded arrays.

Own copy of the RGB path of `sais_tpu/data/collate.py` without pandas.
The reference pad_collate (prepare_dataset.py:2808-2935) pads each batch
to its longest segment; the JAX package rounds that length up to a bucket
(16, 32, 64, 128), and the port keeps the buckets so that both packages
see the same arrays.  Mask semantics: mask[i, :, len_i + 1:] = True, slot 0
the always-valid CLS (createPaddingMask, prepare_dataset.py:2798-2806).
The skill path's collation (with its flow rows) is `data/skill.py`.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Sequence

import numpy as np

from sais_tpu_torch.config import WindowConfig
from sais_tpu_torch.data.datasets import CachingStore, Row, batched_indices
from sais_tpu_torch.data.windows import segment_frame_indices

BUCKETS = (16, 32, 64, 128)


def bucket_for(n: int, buckets: Sequence[int] = BUCKETS) -> int:
    """The first bucket that holds n frames; raises past the last."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"length {n} exceeds largest bucket {buckets[-1]}")


def collate_segments(rows: Sequence[Row], rgb_store,
                     label_to_col: Dict[Any, int], wcfg: WindowConfig,
                     tta_offset: int = 0) -> Dict[str, np.ndarray]:
    """One batch from segment rows (Video / StartFrame / EndFrame /
    Gesture); rgb_store has read_video(name) -> (N, D).  Returns the batch
    dict PrototypeTrainer consumes: rgb (B, 1, F, D) f32, rgb_mask
    (B, 1, F + 1) bool, label_cols and labels (B,) int32."""
    feats: List[np.ndarray] = []
    cols: List[int] = []
    for row in rows:
        reps = rgb_store.read_video(row["Video"])
        idx = segment_frame_indices(int(row["StartFrame"]),
                                    int(row["EndFrame"]), wcfg, tta_offset)
        feats.append(reps[idx])
        cols.append(label_to_col[row["Gesture"]])
    b, d = len(feats), feats[0].shape[1]
    fb = bucket_for(max(len(x) for x in feats))
    rgb = np.zeros((b, 1, fb, d), np.float32)
    rgb_mask = np.zeros((b, 1, fb + 1), bool)
    for i, x in enumerate(feats):
        rgb[i, 0, :len(x)] = x
        rgb_mask[i, 0, len(x) + 1:] = True
    return {"rgb": rgb, "rgb_mask": rgb_mask,
            "label_cols": np.asarray(cols, np.int32),
            "labels": np.asarray(cols, np.int32)}


def segment_batches(rows: Sequence[Row], rgb_store, classes: Sequence,
                    wcfg: WindowConfig, batch_size: int, shuffle: bool,
                    seed: int = 0, tta: bool = False
                    ) -> Iterator[Dict[str, Any]]:
    """Collated batches over a phase's segment rows.  tta=True (val / test)
    attaches the reference's 3-way TTA variants (offsets +0 / +3 / +6,
    prepare_dataset.py:2645-2656) under a 'tta' key; the trainer means
    losses and probabilities over them (perform_training.py:126-149)."""
    label_to_col = {c: i for i, c in enumerate(classes)}
    offsets = tuple(wcfg.tta_offsets) if tta else (0,)
    for idx in batched_indices(len(rows), batch_size, shuffle, seed):
        # one read per distinct video per batch, shared by the variants
        store = CachingStore(rgb_store)
        picked = [rows[i] for i in idx]
        variants = [collate_segments(picked, store, label_to_col, wcfg,
                                     tta_offset=off) for off in offsets]
        out = dict(variants[0])
        if tta:
            out["tta"] = variants
        yield out
