"""The readings that a cell's limits are set from: for each seed, the
program's numbers (as a run compares them) and its control's, the same
numbers with the control in the program's place (the program's own lower
precision path where it has one, else the reference in the precision
below the configuration's).  One process runs every seed of a one-card
cell; a multi-card cell runs its ranks once a seed.

    python3 portbench/controls.py --workload <name> --seeds 1 2 3 \
        [--seconds S]

    python3 portbench/controls.py --workload <name> --seeds 1 2 3 \
        --fault half_batch

    python3 portbench/controls.py --workload <name> --seeds 4 5 6 \
        --no-control

Prints one JSON line a seed: {"seed", "fault", "program": {name: value},
"control": {name: value}, "limits": {name: limit}}; with --fault the
program's numbers are read with that fault planted (`faults.py`) and no
control is read (nor with --no-control).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import registry  # noqa: E402


def readings(spec, seed, seconds, device, mesh=None, fault=None,
             control=True):
    """(program's compared, control's compared) of one seed: set-up, a
    short window at the cell's load, then both comparisons.  With `fault`
    (a name of `faults.FAULTS`) planted in the program during set-up and
    window, the control is not read (None)."""
    from portbench import faults
    from portbench.harness import Parts, _Stop
    kind = spec["traffic"]["entry"]
    entry = registry.module("entries", kind)
    stop = _Stop(mesh)
    cell = entry.Cell(spec, seed, device, mesh)
    cell.parts = Parts()
    with (faults.FAULTS[kind][fault]() if fault else contextlib.nullcontext()):
        cell.setup()
        t0 = time.perf_counter()
        while not stop(time.perf_counter() - t0 >= seconds):
            cell.step()
        cell.finish()
    control = cell.control() if control and not fault else None
    cell.release()
    program = cell.check()
    return program, control


def _rank_readings(spec, seed, seconds, out_path, fault, control):
    import torch
    from sais_tpu_torch.parallel.mesh import make_mesh
    device = torch.device("cuda", torch.distributed.get_rank())
    got = readings(spec, seed, seconds, device, make_mesh(), fault, control)
    if torch.distributed.get_rank() == 0:
        with open(out_path, "w") as f:
            json.dump(got, f)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--fault", default=None,
                   help="a fault of faults.FAULTS planted in the program")
    p.add_argument("--no-control", action="store_true",
                   help="read the program's numbers only")
    args = p.parse_args(argv)
    import torch
    from portbench.harness import build_kernels
    spec = registry.cell_spec(args.workload)
    build_kernels(spec)
    chips = int(spec["workload"]["chips"])
    for seed in args.seeds:
        if chips == 1:
            program, control = readings(spec, seed, args.seconds,
                                        torch.device("cuda", 0),
                                        fault=args.fault,
                                        control=not args.no_control)
        else:
            from sais_tpu_torch.parallel.distributed import run_ranks
            tmp = tempfile.mkdtemp(prefix="portbench_")
            out = os.path.join(tmp, "readings.json")
            run_ranks(_rank_readings, chips, "cuda", spec, seed,
                      args.seconds, out, args.fault, not args.no_control)
            with open(out) as f:
                program, control = json.load(f)
            os.unlink(out)
            os.rmdir(tmp)
        print(json.dumps({
            "workload": args.workload, "seed": seed, "fault": args.fault,
            "program": {n: v for n, v, _ in program},
            "control": {n: v for n, v, _ in control or ()},
            "limits": {n: lim for n, _, lim in program}}), flush=True)


if __name__ == "__main__":
    main()
