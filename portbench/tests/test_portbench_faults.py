"""A run with its timed path broken underneath must come out not correct:
each cell's run on the CPU (the look for a card skipped, the rest of the
run as on the card, the port's plain kernel versions at a tiny size) with
each fault of `faults.py` that the cell can have planted in the program."""

import json
import os
import time

import pytest
import torch

from portbench import faults, harness, registry
from portbench.tests import tiny

SEED = 2 ** 31 + 101
ONE_CARD = {"extract": "extract.vits16.b256",
            "temporal_train": "train.temporal.l2000",
            "dino_pretrain": "pretrain.vits8.b64"}
CASES = [(ONE_CARD[kind], name) for kind, table in faults.FAULTS.items()
         for name in table if name != "exchange_left_out"]


def run(workload, seconds=0.5):
    spec = tiny.spec(workload)
    r = harness.run_cell(spec, SEED, seconds, False, torch.device("cpu"),
                         time.perf_counter())
    return harness.result_line(spec, r, False, "cpu", 1)


@pytest.mark.parametrize("workload", sorted(ONE_CARD.values()))
def test_sound_run_is_correct(workload):
    assert run(workload)["correct"]


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_is_caught(workload, fault):
    kind = tiny.spec(workload)["traffic"]["entry"]
    with faults.FAULTS[kind][fault]():
        line = run(workload)
    assert not line["correct"], line["compared"]
    # and under the limits committed for the cell's own size
    committed = registry.read_json("workloads", workload)["limits"]
    assert any(c["value"] > committed[n]
               for n, c in line["compared"].items()), line["compared"]


def _rank(fault, *args):
    with faults.FAULTS["dino_pretrain"][fault]() if fault else \
            _nothing():
        harness.rank_body(*args)


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("fault,correct", [(None, True),
                                          ("exchange_left_out", False)])
def test_exchange_between_cards(tmp_path, fault, correct):
    from sais_tpu_torch.parallel.distributed import run_ranks
    spec = tiny.spec("pretrain.vits8.b64", chips=4)
    out = os.path.join(tmp_path, "result.json")
    torch.set_num_threads(1)
    run_ranks(_rank, 4, "cpu", fault, spec, SEED, 0.2, False,
              time.perf_counter(), out, "cpu")
    with open(out) as f:
        r = json.load(f)
    assert harness.result_line(spec, r, False, "cpu", 4)["correct"] is correct
