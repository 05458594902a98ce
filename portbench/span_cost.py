"""What the program's spans cost, and how well they line up, in one cell's
traced window: after one set-up, the window runs in turns with the
program's spans on (following the profiler) and off
(`profiling.set_enabled(False)`), `--rounds` times each; each turn prints
its rate (units over the window's seconds) and, with spans on, the cell's
per-layer readings.  A last short session compares each of the window
thread's spans with its own range in the exported trace and prints the
largest distance between their ends.

    python3 portbench/span_cost.py --workload <name> --seed <n> [--rounds 3]

One JSON line a turn, then one with the alignment; on several cards every
rank runs the same turns and rank 0 prints.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import registry  # noqa: E402


def _aligned(prof, since) -> dict:
    from sais_tpu_torch.utils import profiling
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.unlink(path)
    base = doc.get("baseTimeNanoseconds", 0)
    me = threading.get_ident()
    mine = collections.defaultdict(list)
    for s in profiling.spans(since):
        if s.thread == me:
            mine[s.name].append((s.start_ns, s.end_ns))
    theirs = collections.defaultdict(list)
    for e in doc["traceEvents"]:
        if e.get("cat") == "user_annotation" and e["name"] in mine:
            a = base + round(e["ts"] * 1000)
            theirs[e["name"]].append((a, a + round(e["dur"] * 1000)))
    gaps = []
    for name, ms in mine.items():
        ts = sorted(theirs[name])
        if len(ts) < len(ms):
            return {"spans": len(ms), "matched": False, "name": name}
        # a span of another thread of the same name may be in the
        # export: match each of ours with the nearest range
        for a0, a1 in sorted(ms):
            b0, b1 = min(ts, key=lambda r: abs(r[0] - a0))
            gaps.append((max(abs(a0 - b0), abs(a1 - b1)), name))
    gaps.sort()
    return {"spans": len(gaps), "matched": True, "base_ns": base,
            "median_ns": gaps[len(gaps) // 2][0],
            "largest_ns": gaps[-1][0], "largest_in": gaps[-1][1]}


def turns(spec, seed, rounds, device, mesh=None):
    import torch
    from torch.profiler import ProfilerActivity, profile
    from portbench import trace as trace_lib
    from portbench.harness import Parts, _sync
    from sais_tpu_torch.utils import profiling
    rank = 0 if mesh is None else torch.distributed.get_rank()
    chips = 1 if mesh is None else torch.distributed.get_world_size()
    entry = registry.module("entries", spec["traffic"]["entry"])
    cell = entry.Cell(spec, seed, device, mesh)
    cell.parts = Parts()
    cell.setup()
    _sync(device)
    out = []
    for r in range(rounds):
        for on in ((True, False) if r % 2 == 0 else (False, True)):
            profiling.clear()
            profiling.set_enabled(None if on else False)
            try:
                t = trace_lib.traced_window(cell, spec, device, chips)
            finally:
                profiling.set_enabled(None)
            line = {"round": r, "spans": on, "rate": t.units / t.window_s,
                    "window_s": t.window_s,
                    "device_idle": t.idle_share()}
            if on:
                line["per_layer"] = {
                    m["name"]: registry.module("metrics", m["name"]).read(t)
                    for m in spec["per_layer"]}
            out.append(line)
    profiling.clear()
    since = profiling.mark()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        cell.step()
        cell.finish()
        _sync(device)
    out.append({"alignment": _aligned(prof, since)})
    cell.release()
    return out if rank == 0 else None


def _rank_turns(spec, seed, rounds, out_path):
    import torch
    from sais_tpu_torch.parallel.mesh import make_mesh
    device = torch.device("cuda", torch.distributed.get_rank())
    got = turns(spec, seed, rounds, device, make_mesh())
    if got is not None:
        with open(out_path, "w") as f:
            json.dump(got, f)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rounds", type=int, default=3)
    args = p.parse_args(argv)
    import torch
    from portbench.harness import build_kernels, power_limit
    t0 = time.perf_counter()
    spec = registry.cell_spec(args.workload)
    build_kernels(spec)
    chips = int(spec["workload"]["chips"])
    if chips == 1:
        lines = turns(spec, args.seed, args.rounds, torch.device("cuda", 0))
    else:
        from sais_tpu_torch.parallel.distributed import run_ranks
        tmp = tempfile.mkdtemp(prefix="portbench_")
        out = os.path.join(tmp, "turns.json")
        run_ranks(_rank_turns, chips, "cuda", spec, args.seed, args.rounds,
                  out)
        with open(out) as f:
            lines = json.load(f)
        os.unlink(out)
        os.rmdir(tmp)
    card = power_limit()
    for line in lines:
        print(json.dumps(dict(line, workload=args.workload, seed=args.seed,
                              card=card)), flush=True)
    print(f"span_cost: {time.perf_counter() - t0:.1f} s", file=sys.stderr)


if __name__ == "__main__":
    main()
