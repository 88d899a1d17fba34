"""BENCHMARK.json against its contract, and every file it names found by
name: each configuration, traffic mix, driver and metric reader."""

import json
import os
import re

import pytest

from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
MAN = harness.manifest()
E2E = {m["name"]: m for m in MAN["end_to_end"]}


def _cells_of(metric):
    return metric.get("workloads", [w["name"] for w in MAN["workloads"]])


def test_top_level_keys_and_sizes():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "perfbench/run.py"]
    assert MAN["paths"] == ["perfbench"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert 1 <= len(MAN["configs"]) <= 24
    assert 1 <= len(MAN["workloads"]) <= 24
    assert 1 <= len(MAN["end_to_end"]) <= 16
    assert 1 <= len(MAN["per_layer"]) <= 128
    path = os.path.join(harness.ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024


def test_names_units_and_uniqueness():
    names = []
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MAN[kind]:
            assert NAME.match(e["name"]), e["name"]
            names.append((kind in ("end_to_end", "per_layer"), e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
                assert e["source"] in SOURCES
    assert len(set(names)) == len(names)
    for c in MAN["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and len(
            c["reduced"]) <= 16
        for text in (c["why"], c["source"]):
            assert 1 <= len(text) <= 200 and "\n" not in text
    for w in MAN["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200


def test_end_to_end_metrics():
    assert "setup_s" in E2E and E2E["setup_s"]["bound"] <= 0.25
    for m in E2E.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for w in MAN["workloads"]:
        got = [m for m in E2E.values() if w["name"] in _cells_of(m)]
        assert "setup_s" in [m["name"] for m in got] and len(got) >= 2


@pytest.mark.parametrize("cfg", MAN["configs"], ids=lambda c: c["name"])
def test_config_file_found_by_name(cfg):
    assert cfg["file"] == f"perfbench/configs/{cfg['name']}.json"
    data = harness.load_json("configs", f"{cfg['name']}.json")
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert data["reduced"] == cfg["reduced"]
    harness.load_module("systems", data["system"])
    assert any(w["config"] == cfg["name"] for w in MAN["workloads"])


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(cell):
    traffic = harness.load_json("traffic", f"{cell['traffic']}.json")
    assert hasattr(harness.load_module("drivers", traffic["driver"]), "run")
    assert any(c["name"] == cell["config"] for c in MAN["configs"])
    per_layer = harness.metrics_for(cell["name"], True, MAN)
    assert per_layer, "every cell reports a per-layer metric"
    pairs = {(w["config"], w["traffic"]) for w in MAN["workloads"]}
    assert len(pairs) == len(MAN["workloads"])


@pytest.mark.parametrize("metric", MAN["end_to_end"] + MAN["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_declares_what_the_manifest_says(metric):
    mod = harness.load_module("metrics", metric["name"])
    assert callable(mod.read)
    assert (mod.UNIT, mod.SOURCE, mod.BETTER) == (
        metric["unit"], metric["source"], metric["better"])
    if metric["name"] in E2E:
        assert mod.MOVES is None
        return
    assert mod.LAYER == metric["layer"] and mod.MOVES == metric["moves"]
    moved = E2E[metric["moves"]]
    for cell in _cells_of(metric):
        assert cell in _cells_of(moved), (metric["name"], cell)


def test_layers_are_named_in_perf_md():
    with open(os.path.join(harness.ROOT, "PERF.md")) as f:
        text = f.read()
    for m in MAN["per_layer"]:
        assert f"| {m['layer']} |" in text, m["layer"]


def test_manifest_is_json_with_no_extra_keys():
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source",
                              "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer",
                             "moves", "workloads"}}
    for kind, keys in allowed.items():
        for e in MAN[kind]:
            assert set(e) <= keys, (kind, set(e) - keys)
    json.dumps(MAN)
