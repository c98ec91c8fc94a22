"""K2's units design beside other revisions', in turns on one card.

Each other revision is a tree holding its `deepfilternet_torch` package (e.g.
a parent commit's, unpacked by `git archive COMMIT deepfilternet_torch` into
a directory `.gitignore` lists). Each side runs in a process of its own that
imports its own package and builds its own `csrc/whole_cell.cu`; both load
the same checkpoint and get the same inputs (made once, on the card, by this
tree's process, and handed to both as files). Then:

  * every K2 case of `chip_smoke.py` (K2_CASES, and K2_BF16_CASES for the
    bfloat16 build; default params and the runtime stages; the design
    forced where the case names one), both builds: the 12 outputs bit for
    bit this tree's;
  * ms a frame at S=64 x 200 and 512 x 30, forced to the units design at
    1056 x 20 and 4096 x 20, and in the rows design (8 rows) at 4096 x 20,
    both builds (CUDA events around 2 calls, as `chip_smoke.py` times K2),
    over ROUNDS rounds in turns (this, others, others reversed, this, ...),
    and the stage split of each: for a tree whose kernel records every
    block's stages while a profiler records (`utils.timings.k2_records`), the
    median and the slowest block by stage, and the ms a frame again with the
    records on; for an older tree, block 0's stage clocks;
  * one frame a call at S=64, both builds: device ms a call over 20 calls
    back to back, and the host's ms a call waited for (median of 50).

Also prints each side's `-Xptxas -v` registers and spills of the kernel.
Exits 1 if any output differs. Not part of the package's build. On a machine
with the card, from the repository's root:

    python3 deepfilternet_torch/csrc/tools/k2_ab.py OTHER_ROOT [OTHER_ROOT ...]
"""

import json
import os
import subprocess
import sys
import tempfile
import time

MODEL_DIR = "pretrained/dfn3_fixture_demo"
HOP = 480
ROUNDS = 6
# (streams, frames, design, rows): the units design's own sizes, then forced
# where the wrapper runs the rows design, then the rows design at the size
# the benchmark's stream cell runs
TIMED = ((64, 200, "units", None), (512, 30, "units", None), (1056, 20, "units", None),
         (4096, 20, "units", None), (4096, 20, "rows", 8))
TAG = "K2AB "


# -- a side: one process, one package -----------------------------------------


def worker(root, model_dir):
    sys.path.insert(0, root)
    import numpy as np
    import torch

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
    built = kernels.build(["whole_cell"])
    log = built["whole_cell"][1] if "whole_cell" in built else ""
    model, df_state, _ = init_df(model_dir)
    runtimes = {}

    def runtime(dtype, stages):
        key = (dtype, json.dumps(stages, sort_keys=True))
        if key not in runtimes:
            runtimes[key] = WholeCellStreamingRuntime(
                model, df_state, RuntimeParams(**stages),
                matmul_dtype=getattr(torch, dtype))
        return runtimes[key]

    def forced(design, rows, fn):
        own = wc._kernel_choice, wc._tile_rows
        if design is not None:
            wc._kernel_choice = lambda *a: design
        if rows is not None:
            wc._tile_rows = lambda *a: rows
        try:
            return fn()
        finally:
            wc._kernel_choice, wc._tile_rows = own

    def events_ms(fn, iters):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

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
                ms = events_ms(call, 2) / frames
        finally:
            wc.RECORD_EVERY = every
        ns = timings.k2_records()[-1]["ns"].astype(np.float64) / frames
        return dict(records_ms=ms, names=list(timings.k2_records()[-1]["stages"]),
                    median=np.median(ns, axis=0).tolist(), slowest=ns.max(axis=0).tolist())

    reply(dict(source=wc.__file__, ptxas=log))
    for line in sys.stdin:
        cmd = json.loads(line)
        op = cmd["op"]
        if op == "quit":
            return
        rt = runtime(cmd["dtype"], cmd.get("stages", {}))
        W, st = rt.weights, rt.statics
        if op == "inputs":  # a case's inputs, as chip_smoke.check_whole_cell makes them
            s, frames = cmd["s"], cmd["frames"]
            rng = np.random.default_rng(100 + s)
            x = torch.from_numpy((rng.standard_normal((s, (4 + frames) * HOP)) * 0.1)
                                 .astype(np.float32)).to(dev)
            carry, _ = wc.cell_process_plain(x[:, : 4 * HOP].contiguous(),
                                             carry_to_flat(rt.init(s)), W, st)
            torch.save(dict(x=x[:, 4 * HOP:].cpu(), carry={k: v.cpu() for k, v in carry.items()}),
                       cmd["path"])
            reply({})
        elif op == "outputs":
            given = torch.load(cmd["path"])
            x = given["x"].to(dev).contiguous()
            carry = {k: v.to(dev) for k, v in given["carry"].items()}
            c, o = forced(cmd["design"], cmd["rows"], lambda: wc.cell_process(x, carry, W, st))
            torch.cuda.synchronize()
            torch.save({k: v.cpu() for k, v in dict(c, audio=o).items()}, cmd["out"])
            reply({})
        elif op == "time":
            s, frames = cmd["s"], cmd["frames"]
            rng = np.random.default_rng(7)
            x = torch.from_numpy((rng.standard_normal((s, frames * HOP)) * 0.1)
                                 .astype(np.float32)).to(dev)
            carry = carry_to_flat(rt.init(s))

            def call():
                return forced(cmd["design"], cmd["rows"], lambda: wc.cell_process(x, carry, W, st))

            res = dict(ms=events_ms(call, 2) / frames)
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
                res["ms"] = events_ms(call, 20)
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

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    model_dir = os.path.abspath(MODEL_DIR)
    t0 = time.perf_counter()
    sides = {"this": Side(os.getcwd(), model_dir)}
    sides.update({root: Side(root, model_dir) for root in sys.argv[1:]})
    failed = []
    try:
        for side in sides.values():  # all build at once
            side.hello = side.read()
        print(f"{len(sides)} sides built and loaded in {time.perf_counter() - t0:.1f} s")
        for name, side in sides.items():
            print(f"{name}: {side.hello['source']}; "
                  + "; ".join(cs.ptxas_report(side.hello["ptxas"], "whole_cell_")))
        tmp = tempfile.mkdtemp()
        for dtype in ("float32", "bfloat16"):
            cases = cs.K2_CASES + (cs.K2_BF16_CASES if dtype == "bfloat16" else ())
            for stages in ({}, cs.K2_RUNTIME_STAGES):
                for s, frames, design, rows in cases:
                    path = os.path.join(tmp, "inputs.pt")
                    sides["this"].ask(op="inputs", dtype=dtype, stages=stages, s=s,
                                      frames=frames, path=path)
                    outs = {}
                    for i, (name, side) in enumerate(sides.items()):
                        out = os.path.join(tmp, f"outputs{i}.pt")
                        side.ask(op="outputs", dtype=dtype, stages=stages, path=path,
                                 design=design, rows=rows, out=out)
                        outs[name] = torch.load(out)
                    tag = (f"K2 {dtype} S={s} x {frames}, design "
                           f"{design or 'own'}{'' if rows is None else f' {rows}'}, "
                           f"{'runtime stages' if stages else 'default params'}")
                    for name in list(sides)[1:]:
                        differ = [k for k in outs["this"]
                                  if not torch.equal(outs["this"][k], outs[name][k])]
                        print(f"{tag}: 12 outputs bit for bit {name}'s: {not differ}"
                              + (f" (differ: {differ})" if differ else ""))
                        if differ:
                            failed.append(f"{tag} vs {name}")
        for dtype in ("float32", "bfloat16"):
            for s, frames, design, rows in TIMED + ((64, 1, "units", None),):
                runs = {name: [] for name in sides}
                for rnd in range(ROUNDS):
                    for name in (list(sides) if rnd % 2 == 0 else list(sides)[::-1]):
                        runs[name].append(sides[name].ask(op="time", dtype=dtype, s=s,
                                                           frames=frames, design=design,
                                                           rows=rows))
                for name, rs in runs.items():
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
                    print(f"K2 {label} {dtype} S={s} x {frames}, {name}, on {smi}: ms a frame "
                          + ", ".join(f"{v:.4f}" for v in ms)
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
    print("every K2 case bit for bit every other side's, both builds")


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        worker(sys.argv[2], sys.argv[3])
    else:
        main()
