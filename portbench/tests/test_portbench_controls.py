"""Each cell's control, at the cell's own size on the card: the program's
own lower-precision path (extraction: W8A8 blocks on K8), or the reference
in the precision below the configuration's in the program's place
(training: TF32 for float32; DINO: float8 e4m3 operands for bf16), must
fail at least one of the cell's limits on three seeds, while the program
passes all of them; and so must each fault of `faults.py` that the cell
can have, planted in the program at the cell's own size.  Runs on the
card only:

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda \
        portbench/tests/test_portbench_controls.py
"""

import pytest
import torch

from portbench import controls, faults, registry

ONE_CARD = [w["name"] for w in registry.benchmark()["workloads"]
            if w["chips"] == 1]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ONE_CARD)
def test_control_fails_and_program_passes(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run at their own size")
    from portbench.harness import build_kernels
    spec = registry.cell_spec(workload)
    build_kernels(spec)
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        program, control = controls.readings(spec, seed, 2.0,
                                             torch.device("cuda", 0))
        assert all(v <= lim for _, v, lim in program), program
        assert any(v > lim for _, v, lim in control), control


FAULTS = [(w, f) for w in ONE_CARD
          for f in faults.FAULTS[registry.cell_spec(w)["traffic"]["entry"]]
          if f != "exchange_left_out"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload,fault", FAULTS)
def test_fault_fails_at_the_cells_size(workload, fault):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run at their own size")
    from portbench.harness import build_kernels
    spec = registry.cell_spec(workload)
    build_kernels(spec)
    for seed in (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13):
        program, _ = controls.readings(spec, seed, 2.0,
                                       torch.device("cuda", 0), fault=fault)
        assert any(v > lim for _, v, lim in program), program
