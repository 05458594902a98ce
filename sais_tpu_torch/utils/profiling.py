"""Stage timing and device traces (counterpart of
`sais_tpu/utils/profiling.py`).

- StageTimer: accumulating wall-clock stage timing with a report table;
- trace(): torch.profiler around a block, written as a Chrome trace;
- device_sync(): wait until every visible CUDA device has finished its
  queued work, so that a stage's time is its compute, not its launches.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, List

import torch


def device_sync() -> None:
    """Synchronize every visible CUDA device (a stage spread over several
    cards would otherwise bleed into the next one's time); nothing without
    CUDA."""
    if not torch.cuda.is_available():
        return
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


class StageTimer:
    """Accumulating named stage timer.

    with timer.stage("decode"): ...
    print(timer.report())
    """

    def __init__(self, sync_device: bool = False):
        self._acc: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}
        self._order: List[str] = []
        self._sync = sync_device

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        if self._sync:
            device_sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._sync:
                device_sync()
            dt = time.perf_counter() - t0
            if name not in self._acc:
                self._acc[name] = 0.0
                self._counts[name] = 0
                self._order.append(name)
            self._acc[name] += dt
            self._counts[name] += 1

    def totals(self) -> Dict[str, float]:
        return dict(self._acc)

    def report(self) -> str:
        total = sum(self._acc.values()) or 1.0
        lines = [f"{'stage':<24}{'total_s':>10}{'calls':>8}{'pct':>7}"]
        for name in self._order:
            t = self._acc[name]
            lines.append(f"{name:<24}{t:>10.3f}{self._counts[name]:>8}"
                         f"{100 * t / total:>6.1f}%")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """torch.profiler over this block (CPU and, where there is one, CUDA
    activity); the trace is written to `log_dir`/trace.json in Chrome's
    format (chrome://tracing, Perfetto)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            device_sync()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
