"""The port's program spans (`utils/profiling`): nesting, self times and
counts; nothing recorded, and no `record_function`, with tracing off;
every span in torch.profiler's exported trace on its own clock; a full
log's drops; the training step's upload counter."""

import collections
import json
import os

import numpy as np
import pytest
import torch

from sais_tpu_torch import config as tconfig
from sais_tpu_torch.models.full_model import (full_model_init,
                                              prototypes_init)
from sais_tpu_torch.train.loop import PrototypeTrainer
from sais_tpu_torch.utils import profiling

# the in-memory clock against the profiler's, once its base is added
ALIGN_NS = 50_000


@pytest.fixture
def spans_on():
    profiling.clear()
    since = profiling.mark()
    profiling.set_enabled(True)
    try:
        yield since
    finally:
        profiling.set_enabled(None)
        profiling.clear()


def _work():
    torch.ones(64, 64) @ torch.ones(64, 64)


def test_spans_nest_with_parents_and_self_times(spans_on):
    with profiling.span("a"):
        _work()
        with profiling.span("b"):
            _work()
            with profiling.span("c"):
                _work()
        with profiling.span("b"):
            _work()
    with profiling.span("d"):
        pass
    ss = profiling.spans(spans_on)
    assert [s.name for s in ss] == ["a", "b", "c", "b", "d"]
    a, b1, c, b2, d = ss
    assert a.parent is None and d.parent is None
    assert b1.parent == b2.parent == a.id and c.parent == b1.id
    assert len({s.thread for s in ss}) == 1
    for child, parent in ((b1, a), (c, b1), (b2, a)):
        assert parent.start_ns <= child.start_ns <= child.end_ns \
            <= parent.end_ns
    own = profiling.self_times(ss)
    assert own[a.id] == a.duration_ns - b1.duration_ns - b2.duration_ns
    assert own[b1.id] == b1.duration_ns - c.duration_ns
    assert own[c.id] == c.duration_ns and own[d.id] == d.duration_ns
    assert all(v >= 0 for v in own.values())


def test_counts_attach_to_the_innermost_open_span(spans_on):
    profiling.count("bytes", 5)          # no span open: dropped
    with profiling.span("outer"):
        profiling.count("bytes", 1)
        with profiling.span("inner"):
            profiling.count("bytes", 2)
            profiling.count("bytes", 3)
            profiling.count("rows", 7)
        profiling.count("bytes", 4)
    outer, inner = profiling.spans(spans_on)
    assert outer.counts == {"bytes": 5}
    assert inner.counts == {"bytes": 5, "rows": 7}


def test_nothing_recorded_and_no_record_function_when_off(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function called with tracing off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    profiling.set_enabled(None)
    assert not profiling.enabled()
    since = profiling.mark()
    with profiling.span("off"):
        profiling.count("bytes", 1)
    assert profiling.spans(since) == []
    assert profiling.mark() == since
    # a kernel's launching function and the step's spans alike
    from sais_tpu_torch.kernels.fused_mha import block_gemm
    block_gemm(torch.ones(4, 32), torch.ones(32, 32), None, "none")
    assert profiling.spans(since) == [] and profiling.mark() == since
    # an explicit off wins over a running profiler
    profiling.set_enabled(False)
    try:
        monkeypatch.undo()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            assert not profiling.enabled()
            with profiling.span("off"):
                pass
    finally:
        profiling.set_enabled(None)
    assert profiling.spans(since) == []


def _traced_session(log_dir):
    """Three (outer, inner) pairs under `profiling.trace`; returns the
    spans recorded, the profiler's ranges of each name (unix-epoch ns)
    and the spans file."""
    since = profiling.mark()
    with profiling.trace(log_dir):
        assert profiling.enabled()
        # the process's first record_function pays torch's lazy set-up
        with profiling.span("warm"):
            pass
        for _ in range(3):
            with profiling.span("sais.test.outer"):
                _work()
                with profiling.span("sais.test.inner"):
                    profiling.count("bytes", 8)
    assert not profiling.enabled()
    with open(os.path.join(log_dir, "trace.json")) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    ranges = collections.defaultdict(list)
    for e in doc["traceEvents"]:
        if e.get("cat") == "user_annotation" and e["name"].startswith(
                "sais.test."):
            start = base + round(e["ts"] * 1000)
            ranges[e["name"]].append((start, start + round(e["dur"] * 1000)))
    with open(os.path.join(log_dir, "spans.json")) as f:
        written = json.load(f)
    return profiling.spans(since), ranges, written


def test_spans_land_in_the_exported_trace_on_its_clock(tmp_path):
    """Each span is stamped inside its record_function range, so it lies
    within it; its ends trail the profiler's by record_function's own
    Python, which a loaded host stretches: the best of three sessions
    must be within 50 us."""
    profiling.set_enabled(None)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    worst = []
    try:
        for attempt in range(3):
            ss, ranges, written = _traced_session(str(tmp_path / str(attempt)))
            assert len(ss) == 7
            offsets = []
            for name in ("sais.test.outer", "sais.test.inner"):
                mine = sorted((s.start_ns, s.end_ns) for s in ss
                              if s.name == name)
                theirs = sorted(ranges[name])
                assert len(mine) == len(theirs) == 3
                for (a0, a1), (b0, b1) in zip(mine, theirs):
                    # inside the range, up to the export's rounding
                    assert b0 - 1000 <= a0 <= a1 <= b1 + 1000
                    offsets += [a0 - b0, b1 - a1]
            worst.append(max(offsets))
            if worst[-1] <= ALIGN_NS:
                break
    finally:
        torch.set_num_threads(threads)
    assert min(worst) <= ALIGN_NS, worst
    assert written["dropped"] == 0
    got = [s for s in written["spans"] if s["name"].startswith("sais.test.")]
    assert [s["name"] for s in got] == ["sais.test.outer",
                                        "sais.test.inner"] * 3
    for outer, inner in zip(got[0::2], got[1::2]):
        assert inner["parent"] == outer["id"]
        assert inner["counts"] == {"bytes": 8}
        assert outer["self_ns"] == (outer["end_ns"] - outer["start_ns"]
                                    - (inner["end_ns"] - inner["start_ns"]))


def test_a_full_log_counts_its_drops(spans_on, monkeypatch):
    monkeypatch.setattr(profiling, "_log", collections.deque(maxlen=4))
    for i in range(7):
        with profiling.span(f"s{i}"):
            pass
    assert [s.name for s in profiling.spans(spans_on)] == ["s3", "s4", "s5",
                                                           "s6"]
    assert profiling.dropped() == 3
    profiling.clear()
    assert profiling.dropped() == 0 and profiling.spans() == []


def test_train_step_counts_the_batch_bytes_it_uploads(spans_on):
    dim = 32
    cfg = tconfig.ModelConfig(rep_dim=dim, modalities="RGB",
                              temporal=tconfig.TemporalConfig(
                                  rep_dim=dim, num_layers=1, num_heads=2,
                                  ffn_dim=64, max_positions=16))
    gen = torch.Generator().manual_seed(0)
    model = full_model_init(gen, cfg)
    keys, protos = prototypes_init(gen, 2, cfg.proj_dim)
    tr = PrototypeTrainer(cfg, tconfig.TrainConfig(lr=0.1), model, keys,
                          protos, device="cpu")
    rng = np.random.default_rng(0)
    b, f = 3, 10
    batch = {"rgb": rng.normal(size=(b, 1, f, dim)).astype(np.float32),
             "rgb_mask": np.zeros((b, 1, f + 1), bool),
             "label_cols": np.array([0, 1, 0], np.int32),
             "labels": np.array([0, 1, 0], np.int32)}
    tr.train_step(batch)
    ss = profiling.spans(spans_on)
    names = {s.name for s in ss}
    assert {"sais.train.step", "sais.train.upload", "sais.train.forward",
            "sais.train.backward", "sais.train.optimizer"} <= names
    step = [s for s in ss if s.name == "sais.train.step"]
    upload = [s for s in ss if s.name == "sais.train.upload"]
    assert len(step) == len(upload) == 1
    assert upload[0].parent == step[0].id
    assert upload[0].counts == {
        "h2d_bytes": sum(v.nbytes for v in batch.values())}
