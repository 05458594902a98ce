"""ctypes wrapper for the native frame pump (`native/frame_pump.cpp`).

Counterpart of `sais_tpu/io/native_loader.py`.  `ensure_built()` compiles
the port's own copy of the C++ source at first use with `g++` against
OpenCV's C++ headers, into `<repo>/build/native/` (never next to the
source), and loads it.  Where there is no compiler or no OpenCV headers,
the build fails, `ensure_built()` returns False (and does not retry in
the process), and `NativeFramePump` raises RuntimeError: the feature
extractor then prints one line and decodes with OpenCV's Python binding
on a thread instead.  The pump is a host decoder; it runs no device code.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from typing import Iterator, Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "native", "frame_pump.cpp")
_OUT_DIR = os.path.join(os.path.dirname(_PKG), "build", "native")
_LIB_PATH = os.path.join(_OUT_DIR, "libframe_pump.so")
_lib = None
_failed: Optional[str] = None
_lock = threading.Lock()


def _opencv_flags():
    try:
        out = subprocess.run(["pkg-config", "--cflags", "--libs", "opencv4"],
                             capture_output=True, text=True, check=True)
        return out.stdout.split()
    except (OSError, subprocess.CalledProcessError):
        return ["-I/usr/include/opencv4", "-lopencv_core",
                "-lopencv_imgproc", "-lopencv_videoio"]


def _build() -> None:
    """g++ into a temporary name, then an atomic rename: processes that
    build at once never load a half-written library."""
    os.makedirs(_OUT_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_OUT_DIR)
    os.close(fd)
    try:
        cmd = [os.environ.get("CXX", "g++"), "-O3", "-shared", "-fPIC",
               "-std=c++17", _SRC, "-o", tmp, *_opencv_flags()]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode:
            lines = res.stderr.strip().splitlines()
            errors = [ln for ln in lines if "error" in ln] or lines
            raise RuntimeError(errors[0] if errors else "g++ failed")
        os.replace(tmp, _LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def ensure_built() -> bool:
    """Build (when missing or older than its source) and load the library;
    returns whether the pump is available.  A failed build is not retried
    in this process."""
    global _lib, _failed
    with _lock:
        if _lib is not None:
            return True
        if _failed is not None:
            return False
        try:
            if (not os.path.exists(_LIB_PATH) or os.path.getmtime(_SRC)
                    > os.path.getmtime(_LIB_PATH)):
                _build()
            lib = ctypes.CDLL(_LIB_PATH)
        except (OSError, RuntimeError) as e:
            _failed = str(e)
            return False
        lib.fp_open.restype = ctypes.c_void_p
        lib.fp_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                ctypes.c_double, ctypes.c_double,
                                ctypes.c_int]
        lib.fp_meta.restype = ctypes.c_int
        lib.fp_meta.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_double),
                                ctypes.POINTER(ctypes.c_long),
                                ctypes.POINTER(ctypes.c_int),
                                ctypes.POINTER(ctypes.c_int)]
        lib.fp_read.restype = ctypes.c_long
        lib.fp_read.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_ubyte),
                                ctypes.c_long]
        lib.fp_close.restype = None
        lib.fp_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return True


class NativeFramePump:
    """Background-threaded decode + center crop + PIL-exact resize to
    uint8 RGB: (B, out_size, out_size, 3) batches, ready for the device's
    normalize."""

    def __init__(self, path: str, out_size: int = 224,
                 crop_h_frac: float = 0.8, crop_w_frac: float = 0.8,
                 queue_cap: int = 256):
        if not ensure_built():
            raise RuntimeError(f"libframe_pump.so unavailable ({_failed})")
        self._h = _lib.fp_open(path.encode(), out_size, crop_h_frac,
                               crop_w_frac, queue_cap)
        if not self._h:
            # also null for an existing file OpenCV cannot open: a
            # RuntimeError keeps the caller's construction-only fallback
            if not os.path.exists(path):
                raise FileNotFoundError(path)
            raise RuntimeError(f"native decoder could not open {path}")
        self.out_size = out_size
        fps, nf = ctypes.c_double(), ctypes.c_long()
        hh, ww = ctypes.c_int(), ctypes.c_int()
        _lib.fp_meta(self._h, ctypes.byref(fps), ctypes.byref(nf),
                     ctypes.byref(hh), ctypes.byref(ww))
        self.fps = fps.value
        self.frame_count = nf.value
        self.source_size = (hh.value, ww.value)

    def read(self, max_frames: int) -> Optional[np.ndarray]:
        out = np.empty((max_frames, self.out_size, self.out_size, 3),
                       np.uint8)
        n = _lib.fp_read(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            max_frames)
        return out[:n] if n > 0 else None

    def batches(self, batch_size: int) -> Iterator[np.ndarray]:
        while (b := self.read(batch_size)) is not None:
            yield b

    def close(self) -> None:
        if self._h:
            _lib.fp_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
