"""The reduction of a profiler trace: device operations inside the window,
each given the kernel span and host op around its launch, the busy union,
the idle gaps by what the host was doing, and a roofline share from the
kernels' captured calls."""

from types import SimpleNamespace

import pytest

from portbench import trace


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


EVENTS = [
    _x("user_annotation", trace.WINDOW, 100, 100),
    _x("cpu_op", "aten::copy_", 101, 3),
    _x("cuda_runtime", "cudaMemcpyAsync", 102, 1, correlation=1),
    _x("user_annotation", "portbench.k2", 110, 20),
    _x("cuda_runtime", "cudaLaunchKernel", 111, 1, correlation=2),
    _x("cuda_runtime", "cudaLaunchKernel", 115, 1, correlation=3),
    _x("cpu_op", "aten::mm", 140, 5),
    _x("cuda_runtime", "cudaLaunchKernel", 141, 1, correlation=4),
    _x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 103, 7, tid=7,
       correlation=1),
    _x("kernel", "flash_fwd_kernel", 120, 30, tid=7, correlation=2),
    _x("kernel", "flash_fwd_kernel", 150, 10, tid=7, correlation=3),
    _x("kernel", "gemm", 170, 10, tid=7, correlation=4),
    _x("kernel", "spin_kernel", 90, 5, tid=7, correlation=9),
    _x("kernel", "late", 300, 5, tid=7, correlation=10),
]


@pytest.fixture
def traced():
    cell = SimpleNamespace(useful_flops=lambda units: 1e9 * units,
                           cfg={})
    km = SimpleNamespace(PEAK="f32_3xtf32_flops",
                         work=lambda cap: cap)
    return trace.Traced(EVENTS, (100, 200), {"k2": [(2e6, 0.0)]},
                        {"k2": km}, steps=2, units=4.0, cell=cell)


def test_window_ops_spans_and_busy(traced):
    assert traced.window_s == pytest.approx(100e-6)
    names = [o["name"] for o in traced.ops]
    assert names == ["Memcpy HtoD (Pinned -> Device)", "flash_fwd_kernel",
                     "flash_fwd_kernel", "gemm"]
    spans = [o["span"] for o in traced.ops]
    assert spans == [None, "portbench.k2", "portbench.k2", None]
    # busy: [103, 110] + [120, 160] + [170, 180]
    assert traced.busy_s == pytest.approx(57e-6)
    assert traced.idle_share() == pytest.approx(43.0)
    assert traced.launches() == 4
    assert traced.kernel_time("k2") == pytest.approx(40e-6)


def test_roofline_and_mfu(traced):
    want = 100 * (2e6 / trace.PEAKS["f32_3xtf32_flops"]) / 40e-6
    assert traced.roofline("k2") == pytest.approx(want)
    assert traced.roofline(["k2"]) == pytest.approx(want)
    assert traced.mfu("bf16_flops") == pytest.approx(
        100 * 4e9 / 100e-6 / trace.PEAKS["bf16_flops"])


def test_breakdown_names_ops_and_gaps(traced):
    b = traced.breakdown()
    assert b["device_ops"][0] == ["flash_fwd_kernel", pytest.approx(40e-6)]
    gaps = dict((n, s) for n, s in b["idle_gaps"])
    # [100, 103] before the copy launched in aten::copy_; [110, 120] and
    # [160, 170] before kernels launched in the k2 span and in aten::mm;
    # [180, 200] to the window's end
    assert gaps["aten::copy_"] == pytest.approx(3e-6)
    assert gaps["portbench.k2"] == pytest.approx(10e-6)
    assert gaps["aten::mm"] == pytest.approx(10e-6)
    assert gaps["window end"] == pytest.approx(20e-6)
