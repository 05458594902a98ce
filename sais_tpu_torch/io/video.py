"""Host-side video decode through OpenCV, imported at first use.

Own copy of `sais_tpu/io/video.py` (`VideoReader`, `dump_frames`,
`read_frame_dir`):
decoded frames stream straight from the container in batches, with no JPEG
round trip; a reference-layout image directory (the rendered flows_%08d.jpg
of `flow --save-flows`) reads in name order.
"""

from __future__ import annotations

import os
from typing import Iterator, Tuple

import numpy as np


class VideoReader:
    """Sequential RGB frame stream over an mp4 (or any OpenCV-decodable
    container)."""

    def __init__(self, path: str):
        try:
            import cv2
        except ImportError as e:
            raise RuntimeError("OpenCV (cv2) is required for video "
                               "decode") from e
        self._cv2 = cv2
        self._cap = cv2.VideoCapture(path)
        if not self._cap.isOpened():
            raise FileNotFoundError(f"cannot open video: {path}")
        self.path = path

    @property
    def fps(self) -> float:
        return float(self._cap.get(self._cv2.CAP_PROP_FPS))

    @property
    def frame_count(self) -> int:
        return int(self._cap.get(self._cv2.CAP_PROP_FRAME_COUNT))

    @property
    def size(self) -> Tuple[int, int]:
        """(height, width)."""
        return (int(self._cap.get(self._cv2.CAP_PROP_FRAME_HEIGHT)),
                int(self._cap.get(self._cv2.CAP_PROP_FRAME_WIDTH)))

    def frames(self) -> Iterator[np.ndarray]:
        """Yield (H, W, 3) uint8 RGB frames in order."""
        while True:
            ok, bgr = self._cap.read()
            if not ok:
                return
            yield bgr[:, :, ::-1]

    def batches(self, batch_size: int) -> Iterator[np.ndarray]:
        """Yield (B, H, W, 3) uint8 batches; the final batch may be short."""
        buf = []
        for f in self.frames():
            buf.append(f)
            if len(buf) == batch_size:
                yield np.stack(buf)
                buf = []
        if buf:
            yield np.stack(buf)

    def close(self) -> None:
        self._cap.release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def dump_frames(video_path: str, out_dir: str,
                name_format: str = "frames_%08d.jpg") -> int:
    """The reference's frame explosion (video_to_frames.sh:23):
    <out_dir>/frames_%08d.jpg numbered from 1 as ffmpeg numbers them,
    written by OpenCV; returns the number of frames."""
    import cv2
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    with VideoReader(video_path) as r:
        for n, frame in enumerate(r.frames(), start=1):
            cv2.imwrite(os.path.join(out_dir, name_format % n),
                        frame[:, :, ::-1])
    return n


def read_frame_dir(frame_dir: str) -> Iterator[np.ndarray]:
    """Yield the (H, W, 3) uint8 RGB images (.jpg, .png) of a directory in
    sorted name order; a file that does not decode raises, naming it."""
    import cv2
    for name in sorted(os.listdir(frame_dir)):
        if name.endswith(".jpg") or name.endswith(".png"):
            path = os.path.join(frame_dir, name)
            bgr = cv2.imread(path)
            if bgr is None:
                raise IOError(f"failed to decode frame image {path!r}")
            yield bgr[:, :, ::-1]
