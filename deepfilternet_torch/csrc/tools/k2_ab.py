"""K2's units design beside other revisions', in turns on one card.

Each other revision is a tree holding its `deepfilternet_torch` package (e.g.
a parent commit's, unpacked by `git archive COMMIT deepfilternet_torch` into
a directory `.gitignore` lists). Each side runs in a process of its own that
imports its own package and builds its own `csrc/whole_cell.cu` and
`csrc/whole_cell_rows.cu` (at DFN3's geometry and at DFN3-ll's); all sides
load the same checkpoint, or seed the same DFN3-ll model
(`chip_smoke.seeded_models`), and get the same inputs (made once, on the
card, by this tree's process, and handed to all as files). Then:

  * every K2 case of `chip_smoke.py` (K2_CASES; default params and the
    runtime stages; the design forced where the case names one), both
    builds: the 12 outputs bit for bit this tree's, or with `--within REL`
    (for a change that moves a build's rounding) each output within REL of
    its largest value, the largest such difference printed. A case another
    side's kernel refuses (a tile it has no build for) is reported as
    refused there, and compared nowhere;
  * ms a frame in each case of TIMED, each design and tile forced, both
    builds (CUDA events around 2 calls, `timing.time_ms`), over ROUNDS
    rounds in turns (this, others, others reversed, this, ...), and the
    stage split of each: for a tree whose kernel records every block's
    stages while a profiler records (`utils.timings.k2_records`), the
    median and the slowest block by stage, and the ms a frame again with the
    records on; for an older tree, block 0's stage clocks. Where a case
    takes a tile of 16 rows, this tree's outputs at 16 rows and at 8 on the
    timed inputs, float32, must be bit for bit the same;
  * one frame a call at S=64, both builds: device ms a call over 20 calls
    back to back, and the host's ms a call waited for (median of 50).

Also prints each side's `-Xptxas -v` registers and spills of each kernel and
of its products' function (gemm), library by library.
Exits 1 if any output differs. Not part of the package's build. On a machine
with the card, from the repository's root:

    python3 deepfilternet_torch/csrc/tools/k2_ab.py [--within REL] OTHER_ROOT [OTHER_ROOT ...]
"""

import json
import os
import subprocess
import sys
import tempfile
import time

MODEL_DIR = "pretrained/dfn3_fixture_demo"
ROUNDS = 6
# (streams, frames, design, rows, geometry): each size in both designs,
# whichever the wrapper picks there (units up to 512 streams on 132
# multiprocessors, rows above; the stream cells run rows 16 at 4096), and
# rows 8 against 16 where tiles of 8 outnumber the multiprocessors (1100: 2
# tiles of 8 for 6 blocks, one of 16 for 69; 2112: 2 of 8, one of 16; 4096:
# 4 or 3 of 8, 2 or 1 of 16), at DFN3's geometry and DFN3-ll's ("ll", rows
# only)
SWEEP = tuple((s, 20, "rows", rows, geo) for geo in ("dfn3", "ll") for s in (1100, 2112, 4096)
              for rows in (8, 16))
TIMED = ((64, 200, "units", None, "dfn3"), (512, 30, "units", None, "dfn3"),
         (512, 30, "rows", 4, "dfn3"), (1056, 20, "units", None, "dfn3"),
         (1056, 20, "rows", 8, "dfn3"), (4096, 20, "units", None, "dfn3")) + SWEEP
TAG = "K2AB "


# -- a side: one process, one package -----------------------------------------


def worker(root, model_dir):
    sys.path.insert(0, root)
    # the side's own chip_smoke.py where its tree has one, else this tree's
    sys.path.append(os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))))
    import numpy as np
    import torch

    import chip_smoke as cs
    import timing
    from deepfilternet_torch import kernels
    from deepfilternet_torch.enhance import init_df
    from deepfilternet_torch.ops import whole_cell as wc
    from deepfilternet_torch.streaming import RuntimeParams
    from deepfilternet_torch.streaming_whole_cell import WholeCellStreamingRuntime, carry_to_flat

    def reply(obj):
        sys.stdout.write(TAG + json.dumps(obj) + "\n")
        sys.stdout.flush()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")
    ll = cs.seeded_models(cs.LOW_LATENCY, cpu=False)[:2]  # resets the config: first
    models = {"dfn3": init_df(model_dir)[:2], "ll": ll}
    logs = {}  # -Xptxas -v of each library, by name and geometry
    ll_defines = wc.rows_defines(wc.cell_geometry(480, 240, 48))
    for geo, defines in (("", ()), (" at DFN3-ll", ll_defines)):
        names = ["whole_cell", "whole_cell_rows"] if not defines else ["whole_cell_rows"]
        for name, (_, text) in kernels.build(names, defines).items():
            logs[name + geo] = text
    runtimes, timed_audio = {}, {}

    def runtime(dtype, stages, geometry="dfn3"):
        key = (dtype, json.dumps(stages, sort_keys=True), geometry)
        if key not in runtimes:
            model, df_state = models[geometry]
            runtimes[key] = WholeCellStreamingRuntime(
                model, df_state, RuntimeParams(**stages),
                matmul_dtype=getattr(torch, dtype))
        return runtimes[key]

    def stage_split(call, frames):
        from deepfilternet_torch.utils import timings

        if not hasattr(timings, "k2_records"):  # block 0's clocks, an older tree
            call()
            torch.cuda.synchronize()
            return dict(clocks=[int(v) for v in wc.cell_process.stage_clocks.cpu()],
                        names=list(wc.cell_process.stage_names))
        from torch.profiler import ProfilerActivity, profile

        timings.k2_clear()
        every, wc.RECORD_EVERY = wc.RECORD_EVERY, 1  # every traced call runs the recording build
        try:
            with profile(activities=[ProfilerActivity.CPU]):
                ms = timing.time_ms(call, 2) / frames
        finally:
            wc.RECORD_EVERY = every
        ns = timings.k2_records()[-1]["ns"].astype(np.float64) / frames
        return dict(records_ms=ms, names=list(timings.k2_records()[-1]["stages"]),
                    median=np.median(ns, axis=0).tolist(), slowest=ns.max(axis=0).tolist())

    reply(dict(source=wc.__file__, ptxas=logs))
    for line in sys.stdin:
        cmd = json.loads(line)
        op = cmd["op"]
        if op == "quit":
            return
        rt = runtime(cmd["dtype"], cmd.get("stages", {}), cmd.get("geometry", "dfn3"))
        W, st = rt.weights, rt.statics
        hop = rt.df_state.hop_size
        if op == "inputs":  # a case's inputs, as chip_smoke.check_whole_cell makes them
            s, frames = cmd["s"], cmd["frames"]
            rng = np.random.default_rng(100 + s)
            x = torch.from_numpy((rng.standard_normal((s, (4 + frames) * hop)) * 0.1)
                                 .astype(np.float32)).to(dev)
            carry, _ = wc.cell_process_plain(x[:, : 4 * hop].contiguous(),
                                             carry_to_flat(rt.init(s)), W, st)
            torch.save(dict(x=x[:, 4 * hop:].cpu(), carry={k: v.cpu() for k, v in carry.items()}),
                       cmd["path"])
            reply({})
            continue
        if op == "outputs":
            given = torch.load(cmd["path"])
            x = given["x"].to(dev).contiguous()
            carry = {k: v.to(dev) for k, v in given["carry"].items()}
        else:  # the timed inputs, made once a size
            s, frames = cmd["s"], cmd["frames"]
            if (s, frames, hop) not in timed_audio:
                rng = np.random.default_rng(7)
                timed_audio[s, frames, hop] = torch.from_numpy(
                    (rng.standard_normal((s, frames * hop)) * 0.1).astype(np.float32)).to(dev)
            x = timed_audio[s, frames, hop]
            carry = carry_to_flat(rt.init(s))

        def call(design=cmd.get("design"), rows=cmd.get("rows")):
            with cs.k2_design(design, rows):
                return wc.cell_process(x, carry, W, st)

        try:
            c, o = call()
        except RuntimeError as e:  # a tile this side's kernel has no build for
            reply(dict(refused=str(e)))
            continue
        if op == "outputs":
            torch.cuda.synchronize()
            torch.save({k: v.cpu() for k, v in dict(c, audio=o).items()}, cmd["out"])
            reply({})
        elif op == "same_bits":  # this tile's outputs against those of `against` rows
            c8, o8 = call(rows=cmd["against"])
            torch.cuda.synchronize()
            a, b = dict(c, audio=o), dict(c8, audio=o8)
            reply(dict(differ=[k for k in a if not torch.equal(a[k], b[k])]))
        elif op == "time":
            res = dict(ms=timing.time_ms(call, 2) / frames)
            if frames > 1:
                res.update(stage_split(call, frames))
            if frames == 1:
                waited = []
                for _ in range(50):
                    t0 = time.perf_counter()
                    call()
                    torch.cuda.synchronize()
                    waited.append((time.perf_counter() - t0) * 1e3)
                res["host_ms"] = float(np.median(waited))
                res["ms"] = timing.time_ms(call, 20)
            reply(res)


class Side:
    def __init__(self, root, model_dir):
        self.root = os.path.abspath(root)
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", self.root, model_dir],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, cwd=self.root)
        self.hello = None  # its first reply, once built and loaded

    def read(self):
        for line in self.proc.stdout:
            if line.startswith(TAG):
                return json.loads(line[len(TAG):])
            sys.stderr.write(f"[{self.root}] {line}")
        raise RuntimeError(f"the process for {self.root} ended (exit {self.proc.wait()})")

    def ask(self, **cmd):
        self.proc.stdin.write(json.dumps(cmd) + "\n")
        self.proc.stdin.flush()
        return self.read()

    def close(self):
        if self.proc.poll() is None:
            self.proc.stdin.write(json.dumps({"op": "quit"}) + "\n")
            self.proc.stdin.close()
            self.proc.wait(timeout=60)


def main():
    import numpy as np
    import torch

    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    import timing

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    args = sys.argv[1:]
    within = None
    if args[:1] == ["--within"]:
        within, args = float(args[1]), args[2:]
    if not args:
        sys.exit(__doc__)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    model_dir = os.path.abspath(MODEL_DIR)
    t0 = time.perf_counter()
    sides = {"this": Side(os.getcwd(), model_dir)}
    sides.update({root: Side(root, model_dir) for root in args})
    failed = []
    try:
        for side in sides.values():  # all build at once
            side.hello = side.read()
        print(f"{len(sides)} sides built and loaded in {time.perf_counter() - t0:.1f} s")
        for name, side in sides.items():
            print(f"{name}: {side.hello['source']}")
            for lib, log in side.hello["ptxas"].items():
                print(f"  {lib}: " + "; ".join(timing.ptxas_report(log, "whole_cell_")
                                               + timing.ptxas_report(log, "gemm")))
        tmp = tempfile.mkdtemp()
        for dtype in ("float32", "bfloat16"):
            for stages in ({}, cs.K2_RUNTIME_STAGES):
                for s, frames, design, rows in cs.K2_CASES:
                    path = os.path.join(tmp, "inputs.pt")
                    sides["this"].ask(op="inputs", dtype=dtype, stages=stages, s=s,
                                      frames=frames, path=path)
                    outs = {}
                    tag = (f"K2 {dtype} S={s} x {frames}, design "
                           f"{design or 'own'}{'' if rows is None else f' {rows}'}, "
                           f"{'runtime stages' if stages else 'default params'}")
                    for i, (name, side) in enumerate(sides.items()):
                        out = os.path.join(tmp, f"outputs{i}.pt")
                        got = side.ask(op="outputs", dtype=dtype, stages=stages, path=path,
                                       design=design, rows=rows, out=out)
                        if "refused" in got:
                            print(f"{tag}: refused by {name}: {got['refused']}")
                            if name == "this":
                                failed.append(f"{tag}, refused by this tree")
                            continue
                        outs[name] = torch.load(out)
                    for name in [n for n in list(sides)[1:] if n in outs and "this" in outs]:
                        differ = [k for k in outs["this"]
                                  if not torch.equal(outs["this"][k], outs[name][k])]
                        print(f"{tag}: 12 outputs bit for bit {name}'s: {not differ}"
                              + (f" (differ: {differ})" if differ else ""))
                        if differ and within is not None:
                            rel = max(float((outs["this"][k] - outs[name][k]).abs().max())
                                      / max(float(outs[name][k].abs().max()), 1e-30)
                                      for k in differ)
                            print(f"  largest difference {rel:.3e} of an output's largest value "
                                  f"(limit {within:g})")
                            differ = differ if rel > within else []
                        if differ:
                            failed.append(f"{tag} vs {name}")
        for dtype in ("float32", "bfloat16"):
            for s, frames, design, rows, geometry in TIMED + ((64, 1, "units", None, "dfn3"),):
                case = dict(dtype=dtype, s=s, frames=frames, design=design, rows=rows,
                            geometry=geometry)
                at = "" if geometry == "dfn3" else " at DFN3-ll"
                if rows == 16 and dtype == "float32":
                    got = sides["this"].ask(op="same_bits", against=8, **case)
                    same = not got.get("differ", True)
                    print(f"K2 rows 16 {dtype} S={s} x {frames}{at}: 12 outputs bit for bit "
                          f"rows 8's: {same}" + ("" if same else f" ({got})"))
                    if not same:
                        failed.append(f"rows 16 against rows 8, {dtype} S={s}{at}")
                runs = {name: [] for name in sides}
                for rnd in range(ROUNDS):
                    for name in (list(sides) if rnd % 2 == 0 else list(sides)[::-1]):
                        runs[name].append(sides[name].ask(op="time", **case))
                for name, rs in runs.items():
                    if "refused" in rs[0]:
                        print(f"K2 {design} {rows} {dtype} S={s} x {frames}{at}: refused by "
                              f"{name}: {rs[0]['refused']}")
                        if name == "this":
                            failed.append(f"{design} {rows} {dtype} S={s}{at}, refused by this")
                        continue
                    ms = [r["ms"] for r in rs]
                    if frames == 1:
                        host = [r["host_ms"] for r in rs]
                        print(f"K2 {design} {dtype} one frame a call, S={s}, {name}, on {smi}: "
                              f"device ms a call (20 back to back) "
                              + ", ".join(f"{v:.4f}" for v in ms)
                              + "; host ms a call waited for (median of 50) "
                              + ", ".join(f"{v:.3f}" for v in host))
                        continue
                    label = design if rows is None else f"{design} {rows}"
                    print(f"K2 {label} {dtype} S={s} x {frames}{at}, {name}, on {smi}: "
                          "ms a frame " + ", ".join(f"{v:.4f}" for v in ms)
                          + f" (median {float(np.median(ms)):.4f})")
                    if "clocks" in rs[0]:
                        clocks = np.asarray([r["clocks"] for r in rs], np.float64).mean(0) / frames
                        total = clocks.sum()
                        print(f"  stage clocks, block 0, cycles a frame (mean of {ROUNDS} calls) "
                              f"{total:.0f}: " + "; ".join(
                                  f"{n} {c:.0f} ({c / total:.1%})"
                                  for n, c in zip(rs[0]["names"], clocks)))
                        continue
                    traced = [r["records_ms"] for r in rs]
                    print(f"  with the stage records on (under the profiler): ms a frame "
                          + ", ".join(f"{v:.4f}" for v in traced)
                          + f" (median {float(np.median(traced)):.4f}, "
                          f"{float(np.median(traced)) / float(np.median(ms)) - 1:+.2%})")
                    med = np.asarray([r["median"] for r in rs]).mean(0) / 1e3
                    top = np.asarray([r["slowest"] for r in rs]).mean(0) / 1e3
                    print(f"  stages, us a frame (mean of {ROUNDS} calls), median block / "
                          f"slowest block, sum {med.sum():.1f}: " + "; ".join(
                              f"{n} {a:.1f}/{b:.1f}" for n, a, b in zip(rs[0]["names"], med, top)))
    finally:
        for side in sides.values():
            side.close()
    if failed:
        print(f"outputs differ in {len(failed)} case(s): {failed}")
        sys.exit(1)
    print("every K2 case bit for bit every other side's, both builds"
          + ("" if within is None else f", or within {within:g}"))


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        worker(sys.argv[2], sys.argv[3])
    else:
        main()
