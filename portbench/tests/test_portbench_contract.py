"""BENCHMARK.json against the benchmark's contract, and every file a cell
names found where the harness looks for it."""

import json
import re

import pytest

from portbench import registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = registry.benchmark()
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_keys_are_exactly_the_contracts():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["portbench"]
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names_units_and_lines(entry):
    assert NAME.match(entry["name"]), entry["name"]
    if "unit" in entry:
        assert UNIT.match(entry["unit"]), entry["unit"]
        assert entry["better"] in ("lower", "higher")
        assert entry["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200
            assert "\n" not in entry[key] and "\t" not in entry[key]
    for key in entry.get("reduced", []):
        assert NAME.match(key)


def test_names_are_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_files_exist(w):
    cfg = [c for c in BENCH["configs"] if c["name"] == w["config"]]
    assert len(cfg) == 1
    assert (registry.ROOT / cfg[0]["file"]).is_file()
    assert cfg[0]["file"].startswith("portbench/")
    assert w["chips"] in (1, 4)
    assert (registry.HERE / "workloads" / f"{w['name']}.json").is_file()
    traffic = registry.read_json("traffic", w["traffic"])
    assert (registry.HERE / "entries" / f"{traffic['entry']}.py").is_file()


def test_every_config_is_used_and_states_its_cut():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        with open(registry.ROOT / c["file"]) as f:
            data = json.load(f)
        assert data["reduced"] == c["reduced"]
        assert "assumed" in data


def test_end_to_end_metrics_and_bounds():
    names = [m["name"] for m in BENCH["end_to_end"]]
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in BENCH["workloads"]:
        reported = [m for m in BENCH["end_to_end"]
                    if w["name"] in m.get("workloads", [w["name"]])]
        assert len(reported) >= 2, w["name"]


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_moves_a_reported_end_to_end_metric(m):
    e2e = {e["name"]: e for e in BENCH["end_to_end"]}
    assert m["moves"] in e2e and m["moves"] != "setup_s"
    moved = e2e[m["moves"]]
    for w in m["workloads"]:
        assert w in [x["name"] for x in BENCH["workloads"]]
        assert w in moved.get("workloads", [w])
    assert (registry.HERE / "metrics" / f"{m['name']}.py").is_file()
    assert hasattr(registry.module("metrics", m["name"]), "read")


def test_every_cell_reports_a_per_layer_metric():
    for w in BENCH["workloads"]:
        assert registry.cell_spec(w["name"])["per_layer"], w["name"]


def test_layers_are_named_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers <= {"infer.pipeline", "train.loop", "train.dino",
                      "models", "kernels", "parallel", "device"}


def test_four_card_cells_within_the_share():
    fours = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(fours) <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("k", registry.kernel_names())
def test_kernel_files_name_a_target_and_a_peak(k):
    km = registry.module("kernels", k)
    assert km.TARGETS and km.PEAK in json.loads(
        (registry.HERE / "peaks.json").read_text())
