"""One run of one cell: set-up, the measured (or traced) window, the
comparison with the plain reference, and the result line.

A cell's entry (`entries/<entry>.py`) provides `Cell(spec, seed, device,
mesh)` with:

- `setup()`: builds the program's objects and inputs from the seed, runs
  the first steps through `step()` (the ones the reference follows) and
  warms every shape the window uses;
- `step() -> units`: one closed-loop call of the program's entry, the
  units of work it completed (frames, valid tokens, images);
- `finish() -> units`: waits for work still in flight;
- `useful_flops(units)`: the operations the model needs for that work;
- `release()`: frees the program's state;
- `check() -> [(name, value, limit)]`: the comparison with the reference,
  after the window; every number must be at or under its limit.

A cell on several cards runs one rank a card (`parallel.distributed.
run_ranks`); every rank runs the same steps, rank 0 times the window and
writes the result, which the launching process prints.
"""

from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

from portbench import registry

FORBIDDEN = ("jax", "jaxlib", "flax", "sais_tpu")


def forbidden_modules() -> List[str]:
    """Modules of the process whose top-level name is JAX's or the JAX
    package's, compared whole (`sais_tpu_torch` is not `sais_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def build_kernels(spec: Dict[str, Any]) -> None:
    """The port's nvcc libraries of the cell's kernels, built into the
    checkout's build/kernels by the port's own rule (a fixed path, so that
    only a checkout's first run builds), or found there."""
    from sais_tpu_torch.kernels import _build
    _build.build(spec["config"]["kernel_sources"])


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().replace("\n", " | ") or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Parts:
    """Seconds of each part of a set-up, for the run's standard error."""

    def __init__(self):
        self.t = time.perf_counter()
        self.parts = []

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.parts.append((name, now - self.t))
        self.t = now

    def __str__(self):
        return ", ".join(f"{n} {s:.3f}" for n, s in self.parts)


class _Stop:
    """The window's stop decision, shared by every rank through a gloo
    group (no device synchronisation), so that all ranks run the same
    number of steps."""

    def __init__(self, mesh):
        self.group = None
        if mesh is not None:
            import torch.distributed as dist
            self.group = dist.new_group(backend="gloo")

    def __call__(self, stop: bool) -> bool:
        if self.group is None:
            return stop
        import torch
        import torch.distributed as dist
        flag = torch.tensor([int(stop)])
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self.group)
        return bool(flag.item())

    def gather(self, obj: Any) -> List[Any]:
        if self.group is None:
            return [obj]
        import torch.distributed as dist
        out = [None] * dist.get_world_size()
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def barrier(self) -> None:
        if self.group is not None:
            import torch.distributed as dist
            dist.barrier(group=self.group)


def run_cell(spec: Dict[str, Any], seed: int, seconds: float, trace: bool,
             device, t_start: float, mesh=None) -> Optional[Dict[str, Any]]:
    """Set-up, window and check of one rank; rank 0 (or the only rank)
    returns the result, the others None."""
    import torch
    entry = registry.module("entries", spec["traffic"]["entry"])
    stop = _Stop(mesh)
    rank = 0 if mesh is None else torch.distributed.get_rank()
    cell = entry.Cell(spec, seed, device, mesh)
    cell.parts = Parts()
    cell.parts.parts.append(("start", cell.parts.t - t_start))
    cell.setup()
    _sync(device)
    stop.barrier()
    setup_s = time.perf_counter() - t_start
    if rank == 0:
        print(f"set-up {setup_s:.3f} s: {cell.parts}", file=sys.stderr)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    traced = None
    if trace:
        from portbench import trace as trace_lib
        chips = 1 if mesh is None else torch.distributed.get_world_size()
        traced = trace_lib.traced_window(cell, spec, device, chips)
        units, window_s, steps = traced.units, traced.window_s, traced.steps
    else:
        units, steps = 0.0, 0
        t0 = time.perf_counter()
        while not stop(time.perf_counter() - t0 >= seconds):
            units += cell.step()
            steps += 1
        units += cell.finish()
        _sync(device)
        window_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    leaked = forbidden_modules()
    per_layer = {}
    busy = 0.0
    if traced is not None:
        busy = traced.busy_s
        for m in spec["per_layer"]:
            value = registry.module("metrics", m["name"]).read(traced)
            if value is not None:
                per_layer[m["name"]] = {"value": value, "unit": m["unit"]}
    gathered = stop.gather((peak, leaked, busy))
    cell.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    compared = cell.check()
    if rank != 0:
        return None
    peak = max(g[0] for g in gathered)
    leaked = sorted({m for g in gathered for m in g[1]})
    result = {
        "units": units, "steps": steps, "window_s": window_s,
        "setup_s": setup_s, "memory_peak_bytes": peak, "leaked": leaked,
        "compared": [[n, float(v), float(l)] for n, v, l in compared],
        "attempted": cell.attempted, "failed": cell.failed,
        "useful_flops": cell.useful_flops(units), "per_layer": per_layer}
    if traced is not None:
        result["busy_s"] = sum(g[2] for g in gathered) / len(gathered)
        result["breakdown"] = traced.breakdown()
    return result


def rank_body(spec, seed, seconds, trace, t_start, out_path,
              device_type="cuda"):
    """One rank of a multi-card cell (module level, so that spawn can
    pickle it); rank 0 writes the result to out_path."""
    import torch
    from sais_tpu_torch.parallel.mesh import make_mesh
    rank = torch.distributed.get_rank()
    device = (torch.device("cuda", rank) if device_type == "cuda"
              else torch.device(device_type))
    result = run_cell(spec, seed, seconds, trace, device, t_start,
                      mesh=make_mesh())
    if result is not None:
        with open(out_path, "w") as f:
            json.dump(result, f)


def result_line(spec: Dict[str, Any], r: Dict[str, Any], trace: bool,
                kind: str, chips: int) -> Dict[str, Any]:
    correct = (not r["failed"] and bool(r["compared"]) and all(
        math.isfinite(v) and v <= lim for _, v, lim in r["compared"]))
    if trace:
        metrics = r["per_layer"]
    else:
        metrics = {}
        for m in spec["end_to_end"]:
            if m["name"] == "setup_s":
                value = r["setup_s"]
            else:
                value = r["units"] / r["window_s"]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": kind, "count": chips,
              "memory_peak_bytes": int(r["memory_peak_bytes"])}
    line = {"correct": correct, "attempted": r["attempted"],
            "failed": r["failed"], "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = r["busy_s"]
        device["window_s"] = r["window_s"]
        line["breakdown"] = r["breakdown"]
    line["compared"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in r["compared"]}
    return line


def main(workload: str, seed: int, seconds: float, trace: bool,
         t_start: float) -> int:
    spec = registry.cell_spec(workload)
    chips = int(spec["workload"]["chips"])
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"portbench: {workload} needs {chips} CUDA device(s); found "
              f"{found}", file=sys.stderr)
        return 2
    build_kernels(spec)
    print(f"kernels built or found: {time.perf_counter() - t_start:.3f} s "
          f"after start", file=sys.stderr)
    if chips == 1:
        result = run_cell(spec, seed, seconds, trace,
                          torch.device("cuda", 0), t_start)
    else:
        from sais_tpu_torch.parallel.distributed import run_ranks
        tmp = tempfile.mkdtemp(prefix="portbench_")
        out_path = os.path.join(tmp, "result.json")
        try:
            run_ranks(rank_body, chips, "cuda", spec, seed, seconds, trace,
                      t_start, out_path)
            with open(out_path) as f:
                result = json.load(f)
        finally:
            for name in os.listdir(tmp):
                os.unlink(os.path.join(tmp, name))
            os.rmdir(tmp)
    leaked = sorted(set(result["leaked"]) | set(forbidden_modules()))
    if leaked:
        print(f"portbench: modules of JAX or the JAX package were loaded: "
              f"{leaked}", file=sys.stderr)
        return 3
    kind = torch.cuda.get_device_name(0)
    print(f"card: {power_limit()}", file=sys.stderr)
    line = result_line(spec, result, trace, kind, chips)
    print(f"window: {result['steps']} steps, {result['units']} units in "
          f"{result['window_s']:.4f} s; useful {result['useful_flops']:.6g} "
          f"flop", file=sys.stderr)
    for name, c in line["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
