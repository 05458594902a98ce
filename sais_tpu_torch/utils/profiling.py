"""Program spans, stage timing and device traces (counterpart of
`sais_tpu/utils/profiling.py`).

- span(name) / count(name, n): the port's one registry of host spans.
  A span records its name, its parent (the span open on the same thread
  when it began), its thread, its start and end in unix-epoch ns
  (`time.time_ns()`, the clock torch.profiler stamps its events with
  before it writes them relative to its base) and the counts attached to
  it.  Spans record only while a torch.profiler session runs (and so
  inside `trace()`), or where `set_enabled(True)` says so; otherwise a
  span costs one flag check: no clock read, no allocation, no
  `record_function`.  A recorded span is also a `record_function` range
  of the same name (the exported trace holds it on the profiler's clock,
  beside the device rows) and goes to a bounded in-memory log
  (`spans()`, `dropped()`).  Nothing in a span synchronises the device.
- StageTimer: named stages as spans, with the JAX package's report table;
- trace(): torch.profiler around a block, written as a Chrome trace with
  the session's spans, their self times and counts;
- device_sync(): wait until every visible CUDA device has finished its
  queued work, so that a stage's time is its compute, not its launches.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import json
import os
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional

import torch

# spans kept in memory; older ones are dropped first (and counted)
LOG_CAP = 1 << 18

_PROFILER = torch.autograd.profiler
_override: Optional[bool] = None
_log: "collections.deque[Span]" = collections.deque(maxlen=LOG_CAP)
_lock = threading.Lock()
_next_id = [0]
_dropped = [0]
_tls = threading.local()
_NULL = contextlib.nullcontext()


def set_enabled(on: Optional[bool]) -> None:
    """True / False: record spans or not, whatever the profiler does (to
    measure what tracing costs); None: follow the profiler."""
    global _override
    _override = on


def enabled() -> bool:
    """Whether spans record now: the override, else whether a
    torch.profiler session runs."""
    return (_PROFILER._is_profiler_enabled if _override is None
            else _override)


class Span:
    """One recorded span; `end_ns` is None while it is open."""

    __slots__ = ("name", "id", "parent", "thread", "start_ns", "end_ns",
                 "counts")

    def __init__(self, name: str, id: int, parent: Optional[int],
                 thread: int):
        self.name, self.id, self.parent, self.thread = name, id, parent, \
            thread
        self.start_ns: int = 0
        self.end_ns: Optional[int] = None
        self.counts: Dict[str, float] = {}

    @property
    def duration_ns(self) -> int:
        return (self.end_ns or self.start_ns) - self.start_ns


def _stack() -> List[Span]:
    try:
        return _tls.stack
    except AttributeError:
        _tls.stack = []
        return _tls.stack


class _Open:
    """A span being recorded: pushed on its thread's stack; with `log`, a
    `record_function` range and an entry of the log."""

    __slots__ = ("name", "log", "span", "rf")

    def __init__(self, name: str, log: bool = True):
        self.name, self.log, self.rf = name, log, None

    def __enter__(self) -> Span:
        stack = _stack()
        with _lock:
            s = Span(self.name, _next_id[0], stack[-1].id if stack else None,
                     threading.get_ident())
            _next_id[0] += 1
            if self.log:
                _dropped[0] += len(_log) == _log.maxlen
                _log.append(s)
        if self.log:
            self.rf = _PROFILER.record_function(self.name)
            self.rf.__enter__()
        stack.append(s)
        self.span = s
        # stamped inside the profiler's range, so that it holds the span
        s.start_ns = time.time_ns()
        return s

    def __exit__(self, *exc) -> None:
        s = self.span
        s.end_ns = time.time_ns()
        stack = _stack()
        if stack and stack[-1] is s:
            stack.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)


def span(name: str):
    """A context manager that records `name` where spans are on (module
    docstring); a shared no-op otherwise."""
    if not enabled():
        return _NULL
    return _Open(name)


def spanned(name: str) -> Callable:
    """Decorator: every call of the function is a span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not enabled():
                return fn(*args, **kwargs)
            with _Open(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: float) -> None:
    """Add n to counter `name` of the innermost span open on this thread
    (nothing where spans are off or none is open)."""
    if not enabled():
        return
    stack = _stack()
    if stack:
        counts = stack[-1].counts
        counts[name] = counts.get(name, 0) + n


def spans(since: int = 0) -> List[Span]:
    """The closed spans of the log with an id >= since, in start order."""
    return [s for s in list(_log) if s.id >= since and s.end_ns is not None]


def mark() -> int:
    """The id the next span will take (a session's `since`)."""
    with _lock:
        return _next_id[0]


def dropped() -> int:
    """Spans recorded and no longer in the log (it keeps the newest
    LOG_CAP)."""
    return _dropped[0]


def clear() -> None:
    """Empty the log and its count of drops."""
    with _lock:
        _log.clear()
        _dropped[0] = 0


def self_times(ss: List[Span]) -> Dict[int, int]:
    """Each span's duration minus the part its children cover (children
    nest inside their parent on one thread, so their durations add)."""
    covered: Dict[int, int] = collections.defaultdict(int)
    for s in ss:
        if s.parent is not None:
            covered[s.parent] += s.duration_ns
    return {s.id: s.duration_ns - covered[s.id] for s in ss}


def device_sync() -> None:
    """Synchronize every visible CUDA device (a stage spread over several
    cards would otherwise bleed into the next one's time); nothing without
    CUDA."""
    if not torch.cuda.is_available():
        return
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


class StageTimer:
    """Named stages, each a span of the registry (timed whether or not
    spans are recorded); the table reads the timer's own spans.

    with timer.stage("decode"): ...
    print(timer.report())
    """

    def __init__(self, sync_device: bool = False):
        self._spans: List[Span] = []
        self._sync = sync_device

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        if self._sync:
            device_sync()
        opened = _Open(name, log=enabled())
        s = opened.__enter__()
        try:
            yield
        finally:
            if self._sync:
                device_sync()
            opened.__exit__(None, None, None)
            self._spans.append(s)

    def _by_name(self) -> Dict[str, List[Span]]:
        out: Dict[str, List[Span]] = {}
        for s in self._spans:
            out.setdefault(s.name, []).append(s)
        return out

    def totals(self) -> Dict[str, float]:
        return {n: 1e-9 * sum(s.duration_ns for s in ss)
                for n, ss in self._by_name().items()}

    def report(self) -> str:
        totals = self.totals()
        total = sum(totals.values()) or 1.0
        lines = [f"{'stage':<24}{'total_s':>10}{'calls':>8}{'pct':>7}"]
        for name, ss in self._by_name().items():
            t = totals[name]
            lines.append(f"{name:<24}{t:>10.3f}{len(ss):>8}"
                         f"{100 * t / total:>6.1f}%")
        return "\n".join(lines)


def write_spans(path: str, since: int = 0) -> None:
    """The log's spans from id `since` as JSON: each with its parent,
    thread, start and end (unix-epoch ns), self time and counts."""
    ss = spans(since)
    own = self_times(ss)
    with open(path, "w") as f:
        json.dump({"dropped": dropped(), "spans": [
            {"name": s.name, "id": s.id, "parent": s.parent,
             "thread": s.thread, "start_ns": s.start_ns,
             "end_ns": s.end_ns, "self_ns": own[s.id],
             "counts": s.counts} for s in ss]}, f)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """torch.profiler over this block (CPU and, where there is one, CUDA
    activity), which records the program's spans; written to `log_dir`:
    trace.json in Chrome's format (chrome://tracing, Perfetto) and
    spans.json, the session's spans with their self times and counts."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    since = mark()
    with torch.profiler.profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            device_sync()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    write_spans(os.path.join(log_dir, "spans.json"), since)
