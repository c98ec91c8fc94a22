"""Cells are data: one added by adding files and a manifest entry is listed
and runs, one the manifest does not list is refused; the command refuses to
run without a card."""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[1]


def test_a_cell_added_by_files_is_listed_and_runs(tmp_path):
    root = tmp_path / "benchmark"
    shutil.copytree(ROOT, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((root / "workloads" / "dfn3.stream_s4096.json").read_text())
    spec["params"].update(streams=4, frames=2, pool=1, sample_every=2, keep_every=1,
                          ref_rows=4, fixed_calls=2)
    (root / "workloads" / "dfn3.stream_dummy.json").write_text(json.dumps(spec))
    assert "dfn3.stream_dummy" in harness.list_cells(root)
    assert "dfn3.stream_dummy" not in harness.list_cells(ROOT)
    manifest = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    with pytest.raises(SystemExit):  # not in the manifest yet: no bound behind it
        harness.run("dfn3.stream_dummy", 7, 0.1, False, time.perf_counter(), device="cpu",
                    root=root)
    entry = dict(next(w for w in manifest["workloads"] if w["name"] == "dfn3.stream_s4096"),
                 name="dfn3.stream_dummy")
    manifest["workloads"].append(entry)
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "dfn3.stream_s4096" in m.get("workloads", []):
            m["workloads"].append("dfn3.stream_dummy")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    r = harness.run("dfn3.stream_dummy", 7, 0.1, False, time.perf_counter(), device="cpu",
                    root=root)
    assert r["correct"] and "stream_rtf" in r["metrics"] and "setup_s" in r["metrics"]


def test_no_card_no_result():
    repo = ROOT.parent
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "dfn3.stream_s4096", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=repo, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
