"""Raw-video training data: frame JPEGs -> normalized snippet batches.

Own copy of `sais_tpu/data/raw.py` without pandas or cv2: a table is a
list of row dicts (`data.datasets`), and the snippets are cropped,
resized and normalized in torch on the frames' device (the card unless
the caller keeps them on the CPU).  It replicates the reference's
data_type='raw' branch for the VUA_EASE stitch datasets
(prepare_dataset.py:1795-1990):

- 16-frame snippets per annotated segment: Needle Withdrawal samples the
  +/-40-frame window around the withdrawal start; Handling / Driving drop
  the last 20% of frames; jump = span // 16, cut to 16 indices
  (:1870-1915).  Frame numbers are used as they are, with NO -1 (the raw
  path's off-by-one differs from the reps path, :1822);
- TTA offsets +3 / +6 at val / test shift the start of the RAW annotation
  span (:1875-1878, :1884-1886, :1906-1908);
- JPEGs are read from <root>/<dataset>/Images/<video>/frames_%08d.jpg,
  numbered from 1 (loadImages, :1923-1934);
- preprocessing (processImages, :1936-1947): /255, center crop 0.8H x
  0.8W at origin int(round((H - ch) / 2)), a bilinear resize of the float
  frame to (width, width) without antialiasing and with half-pixel
  centres (cv2.INTER_LINEAR on float32 in the JAX package, torchvision's
  tensor resize in the reference; here `resize_linear`, within 2 ulp of
  OpenCV's), normalize with the encoder's
  statistics (Kinetics for R3D, ImageNet for ViT, :1916-1922);
- flow snippets use jump = fps // 2 a video, with NO unique() (:1973-1976).

`frame_source` is any callable (video, indices, modality) -> (T, H, W, 3)
uint8, so frames can come from memory as well as from JPEGs
(`jpeg_frame_source`).
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import Callable, Dict, Iterator, Mapping, Optional, Sequence, \
    Tuple

import numpy as np
import torch

from sais_tpu_torch.config import VUA_FPS_TABLE
from sais_tpu_torch.data.datasets import Row, batched_indices
from sais_tpu_torch.data.skill import RACE_FRAME_COLUMNS, encode_skill_label

RAW_SNIPPET_LEN = 16  # 'MODIFIED to take only 16 frames' (:1890)

# encoder normalization statistics (prepare_dataset.py:1916-1922)
R3D_MEAN = (0.43216, 0.394666, 0.37645)
R3D_STD = (0.22803, 0.22145, 0.216989)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

FrameSource = Callable[[str, np.ndarray, str], np.ndarray]


def raw_segment_indices(row: Row, tta_offset: int = 0) -> np.ndarray:
    """The 16-frame sampling grid of one stitch segment, raw path
    (prepare_dataset.py:1870-1915), in frame-number space (no -1).  A TTA
    variant samples from the raw annotation span, not the race-adjusted
    window (indices2 = arange(start + 3, end + 3, jump)[:16], :1884)."""
    race = row["RACE"]
    cols = RACE_FRAME_COLUMNS[race]
    start_f, end_f = int(row[cols[0]]), int(row[cols[1]])
    if race == "Needle Withdrawal":
        start, end = start_f - 40, start_f + 40
    else:
        start, end = start_f, end_f - int((end_f - start_f) * 0.20)
    jump = max((end - start) // RAW_SNIPPET_LEN, 1)
    if tta_offset:
        idx = np.arange(start_f + tta_offset, end_f + tta_offset, jump)
    else:
        idx = np.arange(start, end, jump)
    return idx[:RAW_SNIPPET_LEN]


def jpeg_frame_source(root: str, dataset: str = "VUA") -> FrameSource:
    """loadImages (prepare_dataset.py:1923-1934): the frames of
    <root>/<dataset>/{Images|Flows}/<video>/{frames|flows}_%08d.jpg at
    frame numbers indices + 1, read with Pillow (imported at the first
    read)."""

    def load(video: str, indices: np.ndarray, modality: str = "RGB"
             ) -> np.ndarray:
        from PIL import Image
        folder, stem = (("Images", "frames") if modality == "RGB"
                        else ("Flows", "flows"))
        return np.stack([np.asarray(Image.open(os.path.join(
            root, dataset, folder, video, f"{stem}_{int(i) + 1:08d}.jpg")))
            for i in indices])

    return load


@lru_cache(maxsize=64)
def linear_taps(in_size: int, out_size: int
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Half-pixel bilinear taps along one axis: the source coordinate
    (d + 0.5) * in / out - 0.5 in double, s = floor, f = the remainder;
    where s < 0 or s >= in - 1 the tap clamps to the edge with f = 0.
    Returns (s, s + 1 clamped, 1 - f, f), the weights rounded to float32
    from double, as OpenCV's IPP-backed INTER_LINEAR on float32 takes
    them."""
    fx = (np.arange(out_size) + 0.5) * (in_size / out_size) - 0.5
    sx = np.floor(fx).astype(np.int64)
    fx = fx - sx
    edge = (sx < 0) | (sx >= in_size - 1)
    fx[edge] = 0.0
    sx = np.clip(sx, 0, in_size - 1)
    return (sx, np.minimum(sx + 1, in_size - 1),
            (1.0 - fx).astype(np.float32), fx.astype(np.float32))


def resize_linear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(..., H, W, C) float32 -> (..., out_h, out_w, C): the bilinear
    resize of cv2.INTER_LINEAR on float32 (half-pixel centres, no
    antialiasing on a downscale, edges clamped), columns first, then
    rows, each a0 * x[s] + a1 * x[s + 1] in float32.  It is bitwise
    numpy's float32 evaluation of the same formula; OpenCV (through IPP)
    sums in an order of its own and lands within 2 ulp of it."""
    for axis, size in ((x.dim() - 2, out_w), (x.dim() - 3, out_h)):
        s0, s1, w0, w1 = linear_taps(x.shape[axis], size)
        shape = [1] * x.dim()
        shape[axis] = size
        a0 = torch.as_tensor(w0, device=x.device).reshape(shape)
        a1 = torch.as_tensor(w1, device=x.device).reshape(shape)
        x = (x.index_select(axis, torch.as_tensor(s0, device=x.device)) * a0
             + x.index_select(axis, torch.as_tensor(s1, device=x.device))
             * a1)
    return x


def process_snippet(frames_u8, width: int, mean: Sequence[float],
                    std: Sequence[float],
                    device: Optional[torch.device] = None) -> torch.Tensor:
    """processImages (prepare_dataset.py:1936-1947): (T, H, W, 3) uint8
    (numpy or a tensor) -> (T, width, width, 3) float32 on `device` (the
    tensor's own, or the CPU for numpy): /255, the 0.8 center crop at
    origin int(round((H - ch) / 2)), `resize_linear`, normalize."""
    x = torch.as_tensor(frames_u8)
    if device is not None:
        x = x.to(device)
    h, w = x.shape[1:3]
    ch, cw = int(0.8 * h), int(0.8 * w)
    top, left = int(round((h - ch) / 2.0)), int(round((w - cw) / 2.0))
    crop = x[:, top:top + ch, left:left + cw].float() / 255.0
    y = resize_linear(crop, width, width)
    m = torch.tensor(mean, dtype=torch.float32, device=y.device)
    s = torch.tensor(std, dtype=torch.float32, device=y.device)
    return (y - m) / s


def collate_raw(rows: Sequence[Row], frame_source: FrameSource,
                classes: Sequence[int], domain: str, phase: str,
                width: int = 112, encoder_type: str = "R3D",
                use_flow: bool = False, tta_offset: int = 0,
                fps_table: Mapping[str, float] = VUA_FPS_TABLE,
                device: Optional[torch.device] = None
                ) -> Dict[str, torch.Tensor]:
    """One raw batch: {'raw': (B, 1, T, W, W, 3) float32 on `device`,
    'labels': (B,) int32} (+ 'raw_flow' with use_flow).  A video missing
    from fps_table raises KeyError with use_flow, as the reference's
    fps_dict does."""
    mean, std = ((R3D_MEAN, R3D_STD) if encoder_type == "R3D"
                 else (IMAGENET_MEAN, IMAGENET_STD))
    snippets, flows, labels = [], [], []
    for row in rows:
        video = str(row["Video"])
        idx = raw_segment_indices(row, tta_offset)
        snippets.append(process_snippet(frame_source(video, idx, "RGB"),
                                        width, mean, std, device))
        if use_flow:
            if video not in fps_table:
                raise KeyError(
                    f"video {row['Video']!r} not in the VUA fps table "
                    "(config.VUA_FPS_TABLE); pass fps_table or extend it")
            jump = int(fps_table[video] // 2)
            flows.append(process_snippet(
                frame_source(video, idx // jump, "Flow"), width, mean, std,
                device))
        labels.append(encode_skill_label(int(row["maj"]),
                                         row.get("Domain", domain), domain,
                                         classes))
    batch = {"raw": torch.stack(snippets)[:, None],
             "labels": torch.as_tensor(np.asarray(labels, np.int32))}
    if flows:
        batch["raw_flow"] = torch.stack(flows)[:, None]
    return batch


def raw_batches(phase_rows: Sequence[Row], frame_source: FrameSource,
                classes: Sequence[int], domain: str, phase: str,
                batch_size: int, shuffle: bool, width: int = 112,
                encoder_type: str = "R3D", use_flow: bool = False,
                seed: int = 0, tta: bool = False,
                device: Optional[torch.device] = None
                ) -> Iterator[Dict]:
    """Raw snippet batches in `batched_indices` order; with tta each
    carries its 3 variants (offsets 0, 3, 6) under 'tta'."""
    offsets = (0, 3, 6) if tta else (0,)
    for idx in batched_indices(len(phase_rows), batch_size, shuffle, seed):
        rows = [phase_rows[i] for i in idx]
        variants = [collate_raw(rows, frame_source, classes, domain, phase,
                                width, encoder_type, use_flow, off,
                                device=device)
                    for off in offsets]
        out = dict(variants[0])
        if tta:
            out["tta"] = variants
        yield out
