"""The program's own spans and counters (`sais_tpu_torch.utils.profiling`)
in a traced window, on the trace's clock.

The program stamps a span in unix-epoch ns (`time.time_ns()`).  The
profiler's export writes every time in us after taking off a base:
libkineto's unix time floored to a multiple of 7,889,238 s (three months),
or none where it writes absolute times.  The spans read are those of the
thread that ran the window (the readers run on it), which the program
records only while the profiler runs.  Every reader gets None where the
program records no spans (a program without them), where its log dropped
spans, or where a span lies outside the window by more than 50 us: a failed
alignment is a missing reading, never a wrong one.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

BASE_PERIOD_NS = 7_889_238 * 10 ** 9
SLACK_US = 50.0
# a window start past this many us is an absolute unix time (a base-
# relative one stays under three months, 7.9e12 us)
ABSOLUTE_US = 1e14

# (name, start ns, end ns, counts) as the program recorded it
Record = Tuple[str, int, int, Dict[str, float]]
# (name, start us, end us, counts) on the trace's clock
Span = Tuple[str, float, float, Dict[str, float]]


def base_ns(lo_us: float, now_ns: Optional[int] = None) -> int:
    """The base the export took off its times, for a window starting at
    lo_us on the trace's clock."""
    if lo_us >= ABSOLUTE_US:
        return 0
    now = time.time_ns() if now_ns is None else now_ns
    return now - now % BASE_PERIOD_NS


def _program_log() -> Optional[List[Record]]:
    """This thread's closed spans from the program's log, or None where the
    program keeps none or dropped some."""
    try:
        from sais_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "spans") or profiling.dropped():
        return None
    me = threading.get_ident()
    return [(s.name, s.start_ns, s.end_ns, dict(s.counts))
            for s in profiling.spans() if s.thread == me]


def session(t, log: Optional[Sequence[Record]] = None,
            now_ns: Optional[int] = None) -> Optional[List[Span]]:
    """The window's spans on the trace's clock (us), or None where there
    are none or one lies outside [t._lo, t._hi] by more than SLACK_US.
    log: the records to read (default the program's); now_ns: the unix
    time the base is floored from (default now)."""
    if log is None:
        log = _program_log()
    if not log:
        return None
    base = base_ns(t._lo, now_ns)
    out = []
    for name, start, end, counts in log:
        lo, hi = (start - base) / 1000.0, (end - base) / 1000.0
        if lo < t._lo - SLACK_US or hi > t._hi + SLACK_US:
            return None
        out.append((name, lo, hi, counts))
    return out


def _union(ivs):
    out = []
    for a, b in sorted(ivs):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        elif b > a:
            out.append([a, b])
    return out


def _overlap(xs, ys) -> float:
    """The length of the intersection of two sorted, disjoint interval
    lists."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, hi - lo)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_share_in(t, spans: Optional[List[Span]], name: str
                  ) -> Optional[float]:
    """100 x the window's idle time (no device operation running) while
    the host was inside a span `name`, over the window's length; None
    without such spans."""
    if spans is None:
        return None
    mine = _union((max(lo, t._lo), min(hi, t._hi))
                  for n, lo, hi, _ in spans if n == name)
    if not mine:
        return None
    edges = [t._lo] + [x for iv in t.busy_intervals for x in iv] + [t._hi]
    idle = [[a, b] for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    return 100.0 * _overlap(mine, idle) / (t._hi - t._lo)


def counted(spans: Optional[List[Span]], name: str, key: str
            ) -> Optional[float]:
    """The sum of counter `key` over the spans `name`; None without such
    spans."""
    if spans is None:
        return None
    vals = [c.get(key, 0) for n, _, _, c in spans if n == name]
    return float(sum(vals)) if vals else None


def rate_gbps(nbytes: Optional[float], seconds: float) -> Optional[float]:
    """GB/s of nbytes moved in `seconds` of device time; None where either
    is missing."""
    if not nbytes or seconds <= 0:
        return None
    return nbytes / seconds / 1e9
