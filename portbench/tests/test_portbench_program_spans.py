"""The program's spans put on a traced window's clock: the idle time inside
a span name, a counter's sum, None on a log out of line with the window,
and both of the export's conventions (times after a base floored to three
months, absolute times)."""

import pytest

from portbench import program_spans, trace
from portbench.tests.test_portbench_trace import EVENTS, traced  # noqa: F401

# a unix time in ns and the base the export would take off at it
NOW = 1_792_369_591_689_457_719
BASE = NOW - NOW % program_spans.BASE_PERIOD_NS


def _log(spans, base):
    """(name, start us, end us, counts) on the trace's clock -> the
    program's records in unix ns."""
    return [(n, base + round(a * 1000), base + round(b * 1000), c)
            for n, a, b, c in spans]


# the window [100, 200] is busy [103, 110] + [120, 160] + [170, 180]
SPANS = [("sais.extract.pin", 100, 106, {}),              # idle 3
         ("sais.extract.upload", 106, 108, {"h2d_bytes": 64}),
         ("sais.extract.pin", 108, 125, {}),              # idle 10
         ("sais.extract.upload", 190, 195, {"h2d_bytes": 36})]


def test_idle_time_inside_a_span_name(traced):  # noqa: F811
    ss = program_spans.session(traced, _log(SPANS, BASE), now_ns=NOW)
    assert [s[0] for s in ss] == [s[0] for s in SPANS]
    assert ss[1][1] == pytest.approx(106)
    assert program_spans.idle_share_in(traced, ss, "sais.extract.pin") \
        == pytest.approx(13.0)
    # upload: busy over [106, 108], idle over [190, 195]
    assert program_spans.idle_share_in(
        traced, ss, "sais.extract.upload") == pytest.approx(5.0)
    assert program_spans.idle_share_in(traced, ss, "sais.none") is None
    assert program_spans.idle_share_in(traced, None, "sais.extract.pin") \
        is None


def test_counter_sums_and_rates(traced):  # noqa: F811
    ss = program_spans.session(traced, _log(SPANS, BASE), now_ns=NOW)
    assert program_spans.counted(ss, "sais.extract.upload",
                                 "h2d_bytes") == 100
    assert program_spans.counted(ss, "sais.extract.pin", "h2d_bytes") == 0
    assert program_spans.counted(ss, "sais.none", "h2d_bytes") is None
    assert program_spans.counted(None, "sais.extract.upload",
                                 "h2d_bytes") is None
    assert program_spans.rate_gbps(100.0, 1e-6) == pytest.approx(0.1)
    assert program_spans.rate_gbps(None, 1e-6) is None
    assert program_spans.rate_gbps(100.0, 0.0) is None


@pytest.mark.parametrize("shift_us", [-60.0, 60.0, 1e6])
def test_a_misaligned_log_reads_nothing(traced, shift_us):  # noqa: F811
    moved = [(n, a + shift_us, b + shift_us, c) for n, a, b, c in SPANS]
    assert program_spans.session(traced, _log(moved, BASE),
                                 now_ns=NOW) is None
    # inside the slack it still reads
    near = [(n, a - 40, b, c) for n, a, b, c in SPANS]
    assert program_spans.session(traced, _log(near, BASE),
                                 now_ns=NOW) is not None
    assert program_spans.session(traced, [], now_ns=NOW) is None


def test_both_base_conventions(traced):  # noqa: F811
    # a base-relative export: the floor of the unix time to three months
    assert program_spans.base_ns(100.0, NOW) == BASE
    assert BASE % (7_889_238 * 10 ** 9) == 0 and 0 <= NOW - BASE \
        < 7_889_238 * 10 ** 9
    # an export of absolute times: no base
    lo = NOW / 1000.0
    absolute = trace.Traced(
        [dict(e, ts=e["ts"] + lo) for e in EVENTS], (100 + lo, 200 + lo),
        traced.captures, traced.kernels, steps=2, units=4.0,
        cell=traced.cell)
    assert program_spans.base_ns(absolute._lo, NOW) == 0
    ss = program_spans.session(absolute, _log(SPANS, round(lo * 1000)),
                               now_ns=NOW)
    assert ss is not None
    assert program_spans.idle_share_in(absolute, ss, "sais.extract.pin") \
        == pytest.approx(13.0, rel=1e-6)
    # read with the wrong convention, the log falls outside the window
    assert program_spans.session(traced, _log(SPANS, round(lo * 1000)),
                                 now_ns=NOW) is None


def test_the_program_log_of_this_thread():
    """Reading the program's own log: only this thread's spans, and none
    while the program records none."""
    import threading
    from sais_tpu_torch.utils import profiling
    profiling.clear()
    assert program_spans._program_log() == []
    profiling.set_enabled(True)
    try:
        with profiling.span("sais.here"):
            profiling.count("bytes", 3)
        other = threading.Thread(target=_one_span)
        other.start()
        other.join(timeout=10)
        assert not other.is_alive()
    finally:
        profiling.set_enabled(None)
    got = program_spans._program_log()
    assert [(n, c) for n, _, _, c in got] == [("sais.here", {"bytes": 3})]
    profiling.clear()


def _one_span():
    from sais_tpu_torch.utils import profiling
    with profiling.span("sais.there"):
        pass
