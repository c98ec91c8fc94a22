"""One run of one cell: set-up, the measured window, the check against the
reference, the per-layer readers and the result's line.

Everything a cell is sits in data and small modules found by name:
`workloads/<cell>.json` names its configuration (`configs/<config>.json`),
its traffic kind (`traffic/<kind>.py`) and that kind's parameters and
limits; each per-layer metric is read by `metrics/<metric>.py`. Which
metrics a cell reports is `BENCHMARK.json`'s. A cell is added by adding
files and entries.
"""

from __future__ import annotations

import importlib.util
import math
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from benchmark import common, trace

# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "deepfilternet_tpu")


def load_module(path: Path):
    """A module of the benchmark loaded from its file (names may hold dots)."""
    name = "benchmark._loaded." + path.stem.replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def list_cells(root: Path = common.ROOT) -> List[str]:
    return sorted(p.stem for p in (root / "workloads").glob("*.json"))


def load_cell(name: str, root: Path = common.ROOT) -> Dict:
    path = root / "workloads" / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"no cell {name!r}: cells are {', '.join(list_cells(root))}")
    cell = common.load_json(path)
    cell["name"] = name
    return cell


def cell_metrics(cell: str, manifest: Dict):
    """(end-to-end names, per-layer names) the manifest gives this cell; a
    cell it does not list has no bound behind it and is refused."""
    if cell not in {w["name"] for w in manifest["workloads"]}:
        raise SystemExit(f"cell {cell!r} is not in BENCHMARK.json")

    def has(m):
        return "workloads" not in m or cell in m["workloads"]
    e2e = [m["name"] for m in manifest["end_to_end"] if has(m)]
    per = [m["name"] for m in manifest["per_layer"]
           if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)]
    return e2e, per


def forbidden_modules() -> List[str]:
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def run(workload: str, seed: int, seconds: float, traced: bool, t_start: float,
        device: str = "cuda", params: Optional[Dict] = None, fault=None,
        root: Path = common.ROOT) -> Dict:
    """Run the cell once and return the result's object (without printing).
    `params` overrides the cell's traffic parameters and `fault` breaks the
    program (both for the CPU tests only)."""
    cell = load_cell(workload, root)
    if params:
        cell["params"] = dict(cell["params"], **params)
    conf = common.load_config(cell["config"])
    manifest = common.load_json(root.parent / "BENCHMARK.json")
    e2e_names, per_names = cell_metrics(workload, manifest)
    kind = load_module(root / "traffic" / f"{cell['kind']}.py")
    common.set_precision(conf["tf32"])
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    ctx = kind.setup(cell, conf, seed, dev, fault, seconds)
    setup_s = time.perf_counter() - t_start
    if dev.type == "cuda":
        ctx.notes.append(f"memory: peak {torch.cuda.max_memory_allocated(dev)} bytes in set-up")
    ctx.traced = traced
    kind.window(ctx, seconds)
    e2e = dict(kind.end_to_end(ctx), setup_s=setup_s)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    kind.release(ctx)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = kind.check(ctx)
    ctx.notes.append(f"check: {time.perf_counter() - t_check:.3f} s")
    correct = all(v <= lim for v, lim in checks.values())

    units = {m["name"]: m["unit"] for m in manifest["end_to_end"] + manifest["per_layer"]}
    metrics = {}
    if traced:
        for name in per_names:
            value = load_module(root / "metrics" / f"{name}.py").read(ctx)
            if value is not None:
                metrics[name] = {"value": float(value), "unit": units[name]}
    else:
        for name in e2e_names:
            if name in e2e:
                metrics[name] = {"value": float(e2e[name]), "unit": units[name]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak),
                   "power_limit": common.power_limit() if dev.type == "cuda" else "none"}
    result = {"correct": bool(correct), "attempted": int(ctx.attempted),
              "failed": int(ctx.failed), "metrics": metrics, "device": device_info}
    tr = getattr(ctx, "trace", None)
    if traced:
        if tr is None:
            raise RuntimeError("the traced window left no trace")
        device_info.update(busy_s=tr.busy_s(), window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.top_device_ops(), "idle_gaps": tr.idle_gaps()}
    for line in getattr(ctx, "notes", []):
        print(line, file=sys.stderr)
    for name, (v, lim) in checks.items():
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    # a reading that is no number is printed as the largest float, which no
    # limit passes: the result's line stays JSON
    result["checks"] = {k: {"value": v if math.isfinite(v) else sys.float_info.max,
                            "limit": lim} for k, (v, lim) in checks.items()}
    return result


def trace_window(ctx):
    """The profiler context for the traced part of a window."""
    return trace.profiled(ctx.traced)
