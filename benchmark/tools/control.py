"""Readings of the lower-precision control: the reference computed with
TF32 products and convolutions (the configuration states float32 with TF32
off) put in the program's place, at a cell's own size, compared by the
cell's own check. The limits of `correct` lie between the program's
readings and these.

    python3 benchmark/tools/control.py <cell> <calls or hops> <seed>...

Give as many calls as a run of the cell makes in `run_seconds`. Prints one
JSON line a seed.
"""

import json
import os
import sys
from types import SimpleNamespace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import common, harness  # noqa: E402
from benchmark.reference.stream import init_carry, stream_block  # noqa: E402


def stream_control(cell, conf, seed, calls, dev):
    kind = harness.load_module(common.ROOT / "traffic" / "stream.py")
    p = cell["params"]
    W, pool, rows, keep_off = kind.inputs(cell, conf, seed, dev)
    s, blk = p["streams"], p["ref_rows"]
    sampled = {k: torch.empty((len(rows), pool[0].shape[1]), device=dev)
               for k in range(calls) if k % p["keep_every"] == keep_off}
    last = torch.empty_like(pool[0])
    parts = {"result_carry": {}, "before_last": {}}
    common.set_precision(True)
    with torch.no_grad():
        for lo in range(0, s, blk):
            hi = min(s, lo + blk)
            in_blk = (rows >= lo) & (rows < hi)
            carry = init_carry(conf, hi - lo, dev)
            for k in range(calls):
                if k == calls - 1:
                    for name, v in carry.items():
                        parts["before_last"].setdefault(name, []).append(v)
                carry, out = stream_block(W, conf, carry, pool[k % len(pool)][lo:hi])
                if k in sampled:
                    sampled[k][in_blk] = out.index_select(0, rows[in_blk] - lo)
            last[lo:hi] = out
            for name, v in carry.items():
                parts["result_carry"].setdefault(name, []).append(v)
    common.set_precision(False)
    joined = {part: {k: torch.cat(v, dim=1 if k in ("enc_h", "dec_h", "df_h") else 0)
                     for k, v in d.items()} for part, d in parts.items()}
    ctx = SimpleNamespace(p=p, conf=conf, dev=dev, W=W, pool=pool, rows=rows, calls=calls,
                          sampled=sampled, last=last, notes=[], limits=cell.get("limits", {}),
                          **joined)
    return kind.check(ctx), ctx.notes


def offline_control(cell, conf, seed, calls, dev):
    kind = harness.load_module(common.ROOT / "traffic" / "offline.py")
    from benchmark.reference.stream import offline_enhance

    p = cell["params"]
    W = common.seeded_weights(conf, seed, dev)
    samples = int(p["seconds_a_clip"] * conf["sr"])
    pool = [common.speech_like(p["rows"], samples, seed * 7919 + b + 1, dev).cpu().numpy()
            for b in range(p["pool"])]
    off = int(np.random.default_rng(int(seed) % (2 ** 63)).integers(p["keep_every"]))
    kept = [k for k in range(calls) if k % p["keep_every"] == off]
    common.set_precision(True)
    with torch.no_grad():
        outs = {k: offline_enhance(W, conf, torch.from_numpy(pool[k % len(pool)]).to(dev))
                .cpu().numpy() for k in kept + [calls - 1]}
    common.set_precision(False)
    ctx = SimpleNamespace(p=p, conf=conf, dev=dev, W=W, pool=pool, calls=calls,
                          last=outs.pop(calls - 1), outs=outs, notes=[],
                          limits=cell.get("limits", {}))
    return kind.check(ctx), ctx.notes


def main(argv):
    name, count, seeds = argv[1], int(argv[2]), [int(s) for s in argv[3:]]
    cell = harness.load_cell(name)
    conf = common.load_config(cell["config"])
    dev = torch.device("cuda")
    fn = {"stream": stream_control, "offline": offline_control}[cell["kind"]]
    for seed in seeds:
        checks, notes = fn(cell, conf, seed, count, dev)
        print(json.dumps({"cell": name, "seed": seed, "control": "tf32",
                          "checks": {k: v for k, (v, _) in checks.items()}, "notes": notes}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
