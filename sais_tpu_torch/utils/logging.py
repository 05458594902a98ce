"""Metric logging (reference: dino-main/utils.py MetricLogger/SmoothedValue
:224-401; main_dino.py rank-0 JSONL log.txt :505-509).

Own copy of `sais_tpu/utils/logging.py` (no JAX in it).  Single-process
by design.
"""

from __future__ import annotations

import collections
import datetime
import json
import os
import time
from typing import Any, Dict, Iterable, Iterator, Optional


class SmoothedValue:
    """Windowed median/avg tracker (dino utils.SmoothedValue)."""

    def __init__(self, window: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = collections.deque(maxlen=window)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1) -> None:
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self) -> float:
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    def __str__(self) -> str:
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg)


class MetricLogger:
    """Iteration logger with throughput/ETA, and per-epoch JSONL output."""

    def __init__(self, delimiter: str = "  ",
                 jsonl_path: Optional[str] = None):
        self.meters: Dict[str, SmoothedValue] = collections.defaultdict(
            SmoothedValue)
        self.delimiter = delimiter
        self.jsonl_path = jsonl_path

    def update(self, **kwargs: float) -> None:
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def log_every(self, iterable: Iterable, print_freq: int,
                  header: str = "", log=print) -> Iterator:
        i = 0
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        try:
            total = len(iterable)  # type: ignore[arg-type]
        except TypeError:
            total = None
        end = time.time()
        for obj in iterable:
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0:
                meters = self.delimiter.join(
                    f"{k}: {v}" for k, v in self.meters.items())
                eta = ""
                if total:
                    secs = iter_time.global_avg * (total - i)
                    eta = f"eta: {datetime.timedelta(seconds=int(secs))}  "
                log(f"{header} [{i}{'/' + str(total) if total else ''}]  "
                    f"{eta}{meters}  time: {iter_time}")
            i += 1
            end = time.time()
        log(f"{header} done in {time.time() - start:.1f}s")

    def write_epoch(self, epoch: int, **extra: Any) -> None:
        """Append one JSONL line per epoch (main_dino log.txt layout)."""
        if not self.jsonl_path:
            return
        stats = {f"train_{k}": v.global_avg for k, v in self.meters.items()}
        stats.update({"epoch": epoch, **extra})
        os.makedirs(os.path.dirname(self.jsonl_path) or ".", exist_ok=True)
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(stats) + "\n")
