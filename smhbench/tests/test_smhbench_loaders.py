"""The harness finds every configuration, traffic mix, per-layer metric and
limit that BENCHMARK.json names, by name alone."""

import json
import re

import pytest

from smhbench import compare, harness
from smhbench import traffic as T

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("wl", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files(wl):
    w = harness.cell(BENCH, wl)
    cfg = harness.config(w["config"])
    tr = T.load(w["traffic"])
    assert cfg["name"] == w["config"]
    assert tr["feed"] in harness.FEEDS
    lim = compare.limits(wl)
    assert {"marker_gap_px", "ratio_gap", "minimap_gap_px", "frame_errors", "unanswered"} <= set(lim)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_each_per_layer_metric_has_a_reader(metric):
    assert callable(harness.reader(metric))


def test_each_configuration_names_a_counted_route_and_a_reader_of_the_program():
    from smhbench import yardstick as Y

    for c in BENCH["configs"]:
        cfg = harness.config(c["name"])
        assert cfg["route"] in Y.ROUTES
        assert cfg["engine"]["reader"].startswith("smh_tpu_torch.")


def test_a_route_or_reader_it_does_not_know_is_refused():
    from smhbench import yardstick as Y

    s = Y.shapes(harness.R.consts.map_geometry(1920, 1080), {"nz": 10, "win": (20, 30), "band": 15})
    assert Y.kernel_bytes("hostpack", s, "sparse") > 0 and Y.kernel_bytes("hostpack", s, "window-gray") > 0
    with pytest.raises(ValueError):
        Y.kernel_bytes("hostpack", s, "window-binary")
    with pytest.raises(ValueError):
        harness.make_engine({"engine": {"reader": "smhocr"}})
    with pytest.raises(ValueError):
        harness.make_engine({"engine": {"reader": "numpy:ndarray"}})


def test_options_of_a_configuration_must_exist_on_the_object():
    class Obj:
        depth = 3

    o = Obj()
    harness.set_options(o, {"depth": 2}, "the object")
    assert o.depth == 2
    with pytest.raises(AttributeError):
        harness.set_options(o, {"no_such_option": 1}, "the object")


def test_unknown_names_are_refused():
    with pytest.raises(FileNotFoundError):
        harness.config("no-such-config")
    with pytest.raises(FileNotFoundError):
        T.load("no-such-traffic")
    with pytest.raises(FileNotFoundError):
        harness.reader("no_such_metric")
    with pytest.raises(KeyError):
        harness.cell(BENCH, "no-such.cell")


def test_benchmark_json_keeps_to_its_format():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]] + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and c["name"] in used
        assert c["file"].startswith("smhbench/") and json.load(open(harness.ROOT / c["file"]))["name"] == c["name"]
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200 and c["reduced"] == []
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e["setup_s"]
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    layers = set()
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["better"] in ("lower", "higher")
        moved = e2e[m["moves"]].get("workloads", [w["name"] for w in BENCH["workloads"]])
        assert set(m["workloads"]) <= set(moved), m["name"]
        layers.add(m["layer"])
    for w in BENCH["workloads"]:
        assert sum(harness.in_cell(m, w["name"]) for m in BENCH["end_to_end"]) >= 2
        assert any(harness.in_cell(m, w["name"]) for m in BENCH["per_layer"])
    assert layers <= {"Capture", "Loop", "Async fetch", "Host readers", "Upload", "Fused pass", "Kernels", "Device",
                      "Batch", "Set-up"}
