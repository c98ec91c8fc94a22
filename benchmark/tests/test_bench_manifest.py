"""BENCHMARK.json against its required form and against the benchmark's
own files: names and units in the allowed letters, every cell, configuration
and per-layer metric found by name."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REPO = ROOT.parent
MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def all_names():
    m = MANIFEST
    yield from (x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
                for x in m[key])
    yield from (w["config"] for w in m["workloads"])
    yield from (w["traffic"] for w in m["workloads"])
    yield from (k for c in m["configs"] for k in c["reduced"])


@pytest.mark.parametrize("name", sorted(set(all_names())))
def test_name_letters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", MANIFEST["end_to_end"] + MANIFEST["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_form(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    keys = {"name", "unit", "better", "source", "workloads"}
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert set(metric) <= keys | {"bound"}
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= keys | {"layer", "moves"}
        assert TEXT.match(metric["layer"])
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        assert (ROOT / "metrics" / f"{metric['name']}.py").is_file()


def test_top_level_form():
    m = MANIFEST
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert m["paths"] == ["benchmark"] and m["command"][1].startswith("benchmark/")
    assert 1 <= m["run_seconds"] <= 51 and isinstance(m["run_seconds"], int)
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert "setup_s" in {e["name"] for e in m["end_to_end"]}
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in m[key]]
    for key in ("configs", "workloads"):
        assert len({x["name"] for x in m[key]}) == len(m[key])
    assert len({x["name"] for x in m["end_to_end"] + m["per_layer"]}) == len(
        m["end_to_end"]) + len(m["per_layer"]), names


@pytest.mark.parametrize("cell", MANIFEST["workloads"], ids=lambda w: w["name"])
def test_cell_found_by_name(cell):
    from benchmark import harness

    assert TEXT.match(cell["why"]) and cell["chips"] in (1, 4)
    spec = json.loads((ROOT / "workloads" / f"{cell['name']}.json").read_text())
    assert spec["config"] == cell["config"] and spec["chips"] == cell["chips"]
    assert (ROOT / "traffic" / f"{spec['kind']}.py").is_file()
    e2e, per = harness.cell_metrics(cell["name"], MANIFEST)
    assert "setup_s" in e2e and len(e2e) >= 2 and per
    moved = {m["name"]: m["moves"] for m in MANIFEST["per_layer"]}
    assert all(moved[p] in e2e for p in per)


@pytest.mark.parametrize("conf", MANIFEST["configs"], ids=lambda c: c["name"])
def test_config_file(conf):
    assert conf["file"] == f"benchmark/configs/{conf['name']}.json"
    data = json.loads((REPO / conf["file"]).read_text())
    assert data["name"] == conf["name"] and data["reduced"] == conf["reduced"]
    assert data["dtype"] == "float32" and data["tf32"] is False
    assert TEXT.match(conf["source"]) and TEXT.match(conf["why"])


def test_layers_named_in_perf_md():
    text = (REPO / "PERF.md").read_text()
    for m in MANIFEST["per_layer"]:
        assert m["layer"] in text, m["layer"]
