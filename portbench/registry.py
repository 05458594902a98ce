"""Find a cell's files by the names in `BENCHMARK.json`."""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from typing import Any, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark() -> Dict[str, Any]:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def read_json(kind: str, name: str) -> Dict[str, Any]:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def module(kind: str, name: str):
    """portbench/<kind>/<name>.py, imported by path (names may hold dots)."""
    key = f"portbench_{kind}_{name}".replace(".", "_").replace("-", "_")
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(
        key, HERE / kind / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def kernel_names() -> List[str]:
    return sorted(p.stem for p in (HERE / "kernels").glob("*.py"))


def cell_spec(workload: str, bench: Dict[str, Any] = None
              ) -> Dict[str, Any]:
    """The cell's entry of BENCHMARK.json with its workload, configuration
    and traffic files, and the metrics it reports."""
    bench = benchmark() if bench is None else bench
    entries = [w for w in bench["workloads"] if w["name"] == workload]
    if not entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = entries[0]
    cfg_entry = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    with open(ROOT / cfg_entry["file"]) as f:
        config = json.load(f)
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", [workload])
                 and m["moves"] in moved]
    return {"workload": w, "cell": read_json("workloads", workload),
            "config": config, "traffic": read_json("traffic", w["traffic"]),
            "end_to_end": e2e, "per_layer": per_layer}
