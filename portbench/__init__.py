"""Benchmark of `sais_tpu_torch` on NVIDIA H100 cards.

One command runs one cell of `BENCHMARK.json`:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Everything that belongs to one cell, configuration, traffic mix, kernel or
per-layer metric is a file of its own, found by name:

- `workloads/<cell>.json`: the cell's check sizes and correctness limits;
- `configs/<config>.json`: the model's sizes, precision and peak;
- `traffic/<traffic>.json`: the mix's parameters and the entry that
  drives it (`entries/<entry>.py`);
- `kernels/<k>.py`: a hand-written kernel of the port, the function that
  launches it, its device kernel names and the operations and bytes it
  needs for its arguments;
- `metrics/<metric>.py`: a reader of one per-layer metric;
- `reference/`: the plain PyTorch references that decide `correct`.

Nothing here imports `jax` or the JAX package; `reference/` imports
nothing of `sais_tpu_torch` either.
"""
