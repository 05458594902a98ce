"""The traced window: torch.profiler over a few closed-loop steps, with a
`record_function` span around every call of a hand-written kernel's
launching function (`kernels/<k>.py` names it), and the reduction of the
profiler's trace to what the per-layer readers read.

The spans are the benchmark's own: the launching functions are wrapped in
this process for the traced run only.  A device operation belongs to the
innermost span open on the host thread that launched it (the launch call
and the operation share the profiler's correlation id).  Device times are
the operations' own intervals; the busy time is their union.
"""

from __future__ import annotations

import bisect
import importlib
import json
import os
import tempfile
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

from portbench import registry

PEAKS = json.loads((registry.HERE / "peaks.json").read_text())
# spin launches that open the profiler's window: the profiler drops the
# first device records of a window, more as a process runs
PAD = 256
SPIN = "spin_kernel"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "portbench.window"


def _resolve(target: str):
    mod, attr = target.split(":")
    return importlib.import_module(mod), attr


class _Spans:
    """Wraps each kernel's launching function(s) in a named span that also
    keeps what the kernel's `capture` takes from the call."""

    def __init__(self):
        self.captures: Dict[str, List[Any]] = defaultdict(list)
        self.kernels = {k: registry.module("kernels", k)
                        for k in registry.kernel_names()}
        self._saved = []

    def __enter__(self):
        import torch
        for k, km in self.kernels.items():
            for target in km.TARGETS:
                mod, attr = _resolve(target)
                orig = getattr(mod, attr)
                wrapper = self._wrap(k, km, orig, torch)
                setattr(mod, attr, wrapper)
                self._saved.append((mod, attr, orig, wrapper))
        return self

    def _wrap(self, k, km, orig, torch):
        captures = self.captures[k]
        name = f"portbench.{k}"

        def wrapper(*args, **kwargs):
            captures.append(km.capture(*args, **kwargs))
            with torch.profiler.record_function(name):
                return orig(*args, **kwargs)

        if hasattr(orig, "launches"):
            # the launching function counts itself through its module's
            # global name, which is the wrapper while it is in place
            wrapper.launches = orig.launches
        return wrapper

    def __exit__(self, *exc):
        for mod, attr, orig, wrapper in reversed(self._saved):
            setattr(mod, attr, orig)
            if hasattr(wrapper, "launches"):
                orig.launches = wrapper.launches
        self._saved.clear()


class Traced:
    """One traced window, reduced: device operations with their spans, the
    busy union, the kernels' captured calls, and the cell's own counts."""

    def __init__(self, events: List[dict], window: Tuple[float, float],
                 captures, kernels, steps: int, units: float, cell):
        self.steps, self.units, self.cell = steps, units, cell
        self.chips = 1
        self.captures, self.kernels = captures, kernels
        self.peaks = PEAKS
        lo, hi = window
        self.window_s = (hi - lo) * 1e-6
        self.ops = _attribute(events, lo, hi)
        self._starts = [o["ts"] for o in self.ops]
        spans = sorted((o["ts"], o["ts"] + o["dur"]) for o in self.ops)
        self.busy_intervals = _union(spans)
        self.busy_s = sum(b - a for a, b in self.busy_intervals) * 1e-6
        self._lo, self._hi = lo, hi
        self.useful_flops = cell.useful_flops(units)

    # -- what the readers read ---------------------------------------------

    def device_time(self, match=None, span: Optional[str] = None) -> float:
        """Seconds of device operations whose name `match` accepts, launched
        inside `span` (None: anywhere)."""
        return 1e-6 * sum(
            o["dur"] for o in self.ops
            if (span is None or o["span"] == span)
            and (match is None or match(o)))

    def kernel_time(self, k: str) -> float:
        """Seconds of the device kernels launched inside kernel k's calls
        (every kernel its launching function starts, copies left out)."""
        return self.device_time(lambda o: o["cat"] == "kernel",
                                span=f"portbench.{k}")

    def roofline(self, ks) -> Optional[float]:
        """100 x (the least time the calls of kernels `ks` need: operations
        at the kernel's peak or bytes at the memory rate, per call) over
        their device time; None where none ran."""
        ks = [ks] if isinstance(ks, str) else list(ks)
        bound = spent = 0.0
        for k in ks:
            km = self.kernels[k]
            for cap in self.captures.get(k, ()):
                flops, nbytes = km.work(cap)
                bound += max(flops / self.peaks[km.PEAK],
                             nbytes / self.peaks["hbm_bytes_per_s"])
            spent += self.kernel_time(k)
        if spent <= 0 or bound <= 0:
            return None
        return 100.0 * bound / spent

    def mfu(self, peak: str) -> Optional[float]:
        """The cell's useful operations in the window (every card's) over
        the window's length and the peak of all the cards it runs on."""
        if self.useful_flops <= 0 or self.window_s <= 0:
            return None
        return (100.0 * self.useful_flops / self.window_s
                / (self.peaks[peak] * self.chips))

    def idle_share(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def launches(self) -> int:
        return len(self.ops)

    # -- breakdown -----------------------------------------------------------

    def breakdown(self) -> Dict[str, List[List[Any]]]:
        by_name: Dict[str, float] = defaultdict(float)
        for o in self.ops:
            by_name[o["name"][:120]] += o["dur"] * 1e-6
        gaps: Dict[str, float] = defaultdict(float)
        edges = [self._lo] + [x for iv in self.busy_intervals
                              for x in iv] + [self._hi]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                gaps[self._host_at(b)] += (b - a) * 1e-6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, s] for n, s in top],
                "idle_gaps": [[n, s] for n, s in idle]}

    def _host_at(self, t: float) -> str:
        """What the host was doing for the device operation that ends an
        idle gap at t: the innermost host op or span around its launch."""
        i = bisect.bisect_left(self._starts, t)
        if i == len(self.ops):
            return "window end"
        return self.ops[i]["host"] or "host"


def _union(spans):
    out = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(ranges, t):
    """The name of the shortest range of `ranges` ((start, end, name),
    sorted by start) that holds t."""
    best = None
    i = bisect.bisect_right(ranges, (t, float("inf"), ""))
    for start, end, name in reversed(ranges[max(0, i - 64):i]):
        if start <= t <= end and (best is None or end - start < best[0]):
            best = (end - start, name)
    return None if best is None else best[1]


def _attribute(events, lo, hi):
    """Device operations inside [lo, hi] (spin launches left out), each
    with the kernel span and the host op that were open around its
    launch."""
    launches = {}
    spans = defaultdict(list)
    host = defaultdict(list)
    for e in events:
        cat = e.get("cat", "")
        if e.get("ph") != "X":
            continue
        if cat in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (e["tid"], e["ts"])
        elif cat == "user_annotation":
            rng = (e["ts"], e["ts"] + e.get("dur", 0), e["name"])
            if e["name"].startswith("portbench.k"):
                spans[e["tid"]].append(rng)
            host[e["tid"]].append(rng)
        elif cat == "cpu_op":
            host[e["tid"]].append((e["ts"], e["ts"] + e.get("dur", 0),
                                   e["name"]))
    for d in (spans, host):
        for v in d.values():
            v.sort()
    ops = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        if SPIN in e["name"] or e["ts"] < lo or e["ts"] > hi:
            continue
        corr = e.get("args", {}).get("correlation")
        span = hname = None
        if corr in launches:
            tid, t = launches[corr]
            span = _innermost(spans.get(tid, []), t)
            hname = _innermost(host.get(tid, []), t)
        ops.append({"name": e["name"], "cat": e["cat"], "ts": e["ts"],
                    "dur": e.get("dur", 0), "span": span, "host": hname})
    ops.sort(key=lambda o: o["ts"])
    return ops


def traced_window(cell, spec, device, chips: int = 1) -> Traced:
    """`trace_steps` closed-loop steps of the cell under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    steps = int(spec["cell"]["trace_steps"])
    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with _Spans() as sp:
        with profile(activities=activities) as prof:
            if cuda:
                for _ in range(PAD):
                    torch.cuda._sleep(1)
                torch.cuda.synchronize(device)
            units = 0.0
            with record_function(WINDOW):
                for _ in range(steps):
                    units += cell.step()
                units += cell.finish()
                if cuda:
                    torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    window = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not window:
        raise RuntimeError("the profiler's trace holds no window span")
    t = Traced(events, window[0], sp.captures, sp.kernels, steps, units,
               cell)
    t.chips = chips
    return t
