"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level names (`sais_tpu_torch` is not `sais_tpu`), and the
references import nothing of the program."""

import subprocess
import sys

from portbench import registry

PROBE = r"""
import sys
sys.path.insert(0, {root!r})
from portbench import registry, harness, trace, controls, sets, compare, \
    flops, weights
from portbench.reference import dino, temporal, vit, precision
for kind in ("entries", "metrics", "kernels"):
    for p in sorted((registry.HERE / kind).glob("*.py")):
        registry.module(kind, p.stem)
import importlib.util
spec = importlib.util.spec_from_file_location("run", registry.HERE / "run.py")
importlib.util.module_from_spec(spec)
{extra}
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(" ".join(tops))
"""


def _tops(extra=""):
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=str(registry.ROOT),
                                            extra=extra)],
        capture_output=True, text=True, check=True)
    return set(out.stdout.split())


def test_no_jax_nor_the_jax_package():
    tops = _tops()
    assert not tops & {"jax", "jaxlib", "flax", "sais_tpu"}


def test_a_cells_program_pulls_no_jax():
    extra = ("import sais_tpu_torch.train.dino, sais_tpu_torch.train.loop, "
             "sais_tpu_torch.infer.pipeline, "
             "sais_tpu_torch.parallel.distributed")
    tops = _tops(extra)
    assert "sais_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "sais_tpu"}


def test_references_import_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.reference.vit, portbench.reference.temporal, "
            "portbench.reference.dino, portbench.reference.precision; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"
            % str(registry.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    tops = set(out.stdout.split())
    assert not tops & {"sais_tpu_torch", "sais_tpu", "jax", "jaxlib"}


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from portbench import harness
    monkeypatch.setitem(sys.modules, "sais_tpu_torch_like", sys)
    assert "sais_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "sais_tpu.x", sys)
    assert "sais_tpu" in harness.forbidden_modules()
