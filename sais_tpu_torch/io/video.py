"""Host-side video decode through OpenCV, imported at first use.

Own copy of `sais_tpu/io/video.py` (`VideoReader`): decoded frames stream
straight from the container in batches, with no JPEG round trip.
"""

from __future__ import annotations

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
