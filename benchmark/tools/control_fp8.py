"""Readings of a control coarser than bfloat16, for the cells whose program
runs bfloat16 products: the plain reference with the operands of every
matrix product, convolution and GRU (its input, first state and weights)
rounded to float8 e4m3, each tensor scaled so that its largest magnitude
is e4m3's largest (448), put in the program's place at a cell's own size
and compared by the cell's own check. A bfloat16 program's limits of
`correct` lie between its sound readings and these.

    python3 benchmark/tools/control_fp8.py <cell> <calls> <seed>...

Give as many calls as a run of the cell makes in `run_seconds`. Prints one
JSON line a seed. The rounding goes through a `TorchFunctionMode` entered
around each `stream_block` call of `control.stream_control` (the control's
own frames), and not around the cell's check, whose reference stays float32.
The control's TF32 switch then changes nothing in the control's products:
an e4m3 value is exact in TF32.
"""

import json
import os
import sys
from unittest import mock

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.overrides import TorchFunctionMode  # noqa: E402

from benchmark import common, harness  # noqa: E402
from benchmark.reference.stream import stream_block  # noqa: E402
from benchmark.tools import control  # noqa: E402

E4M3_MAX = 448.0


def fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under a per-tensor scale, back in its type."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


def _round(x):
    if isinstance(x, torch.Tensor) and x.is_floating_point() and x.dtype != torch.float64:
        return fp8(x)
    if isinstance(x, (list, tuple)):
        return type(x)(_round(v) for v in x)
    return x


class Fp8Products(TorchFunctionMode):
    """Rounds the tensor operands of the products the reference computes."""

    # `a @ b` arrives as the tensor method `matmul`
    PRODUCTS = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__,
                torch.Tensor.__rmatmul__, torch.mm, torch.bmm, torch.einsum, F.linear, F.conv2d,
                F.conv_transpose2d, torch.gru}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.PRODUCTS:
            if func is torch.einsum:
                args = (args[0],) + tuple(_round(a) for a in args[1:])
            elif func is torch.gru:
                # (input, h0, weights, ...): the biases are rounded with the
                # weights; no operand of the recurrence inside is
                args = (_round(args[0]), _round(args[1]), _round(list(args[2]))) + tuple(args[3:])
            else:
                args = tuple(_round(a) for a in args)
        return func(*args, **kwargs)


def fp8_block(*args, **kwargs):
    """`stream_block` with its products' operands rounded to float8 e4m3."""
    with Fp8Products():
        return stream_block(*args, **kwargs)


def fp8_stream_control(cell, conf, seed, calls, dev):
    """`control.stream_control` with the control's frames, and only those,
    computed through `fp8_block`."""
    with mock.patch.object(control, "stream_block", fp8_block):
        return control.stream_control(cell, conf, seed, calls, dev)


def main(argv):
    name, count, seeds = argv[1], int(argv[2]), [int(s) for s in argv[3:]]
    cell = harness.load_cell(name)
    if cell["kind"] != "stream":
        raise SystemExit("the float8 control reads the stream kind's cells")
    conf = common.load_config(cell["config"])
    dev = torch.device("cuda")
    for seed in seeds:
        checks, notes = fp8_stream_control(cell, conf, seed, count, dev)
        print(json.dumps({"cell": name, "seed": seed, "control": "fp8_e4m3",
                          "checks": {k: v for k, (v, _) in checks.items()}, "notes": notes}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
