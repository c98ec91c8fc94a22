"""Does the bfloat16 units design gain from keeping slices of 4 or 12 columns?

The bfloat16 plan (`ops/whole_cell_plan.py`) lets a unit own a slice of 4
or 12 columns and pads its packed B tile with zero columns to whole n8 tiles
of the tensor cores. The alternative restricts the slices to whole n8 tiles,
which halves the units of the narrow products. This times K2's bfloat16
units design at S=64 x 200 and 512 x 30 frames with the plan as shipped and
with the restricted one, the float32 build beside, in turns, and prints the
median block's us a frame by phase (the kernel's records, taken under the
profiler). Not part of the package's build. On a machine
with the card, from the repository's root:

    python3 deepfilternet_torch/csrc/tools/k2_units_padding_ab.py
"""

import os
import sys

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from deepfilternet_torch.enhance import init_df  # noqa: E402
from deepfilternet_torch.ops import whole_cell as wc  # noqa: E402
from deepfilternet_torch.ops import whole_cell_plan as wp  # noqa: E402
from deepfilternet_torch.streaming_whole_cell import (  # noqa: E402
    WholeCellStreamingRuntime,
    carry_to_flat,
)

SHIPPED = wp._widths


def restricted(job):
    return [cw for cw in SHIPPED(job) if job.ncat * cw % 8 == 0]


def use_plan(widths):
    wp._widths = widths
    wp.cached_plan.cache_clear()
    wc._plan_on_device.cache_clear()
    wc._PACKED.clear()


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    dev = torch.device("cuda")
    print(torch.cuda.get_device_name(0))
    model, df_state, _ = init_df(cs.MODEL_DIR)
    rts = {"float32": WholeCellStreamingRuntime(model, df_state, matmul_dtype=torch.float32),
           "bfloat16": WholeCellStreamingRuntime(model, df_state)}
    variants = [("float32", "float32", SHIPPED), ("bfloat16 padded", "bfloat16", SHIPPED),
                ("bfloat16 whole n8 tiles", "bfloat16", restricted)]
    for s, frames in ((64, 200), (512, 30)):
        x = cs.seeded_audio(s, frames, seed=7).to(dev)
        ms, clk = {}, {}
        for _ in range(3):
            for name, dtype, widths in variants:
                rt = rts[dtype]
                use_plan(widths)
                carry = carry_to_flat(rt.init(s))
                with cs.k2_design("units"):
                    run = lambda: wc.cell_process(x, carry, rt.weights, rt.statics)  # noqa: E731
                    ms.setdefault(name, []).append(cs.time_ms(run, iters=2) / frames)
                    rec = cs.k2_traced_record(run, name)
                clk.setdefault(name, []).append(
                    np.median(rec["ns"].astype(np.float64), axis=0) / frames / 1e3)
        use_plan(SHIPPED)
        for name, _, _ in variants:
            c = np.median(np.stack(clk[name]), axis=0)
            print(f"S={s} x {frames}, {name}: {np.median(ms[name]):.4f} ms a frame (rounds: "
                  + ", ".join(f"{v:.4f}" for v in ms[name]) + f"); the median block "
                  f"{c.sum():.1f} us a frame, by phase: " + " ".join(f"{v:.1f}" for v in c))


if __name__ == "__main__":
    main()
