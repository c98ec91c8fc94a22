"""How the whole cell at bfloat16 operands is held to its plain version.

A kernel that sums a product's float32 terms in another order than the plain
version gets a sum a few float32 units away. Where that sum lies near a
bfloat16 rounding boundary, `mm` rounds it to the neighbouring bfloat16: one
unit in the last place of a pre-activation, which at a GRU gate input of
magnitude ~4 is 0.03 absolute and moves that state by a few percent of its
largest value within the frame. So the largest error of a right kernel
reaches a few percent of an output's scale even one frame from an equal
carry (`Float64Sums`, a plain version that sums in float64: up to 2.6e-2),
and a kernel that skips or misplaces the bfloat16 rounding reads 4.5e-2 to
5.7e-2, within 2x of that: the largest error cannot tell the two apart.
The mean error can: a right kernel leaves almost every value bit-equal
(mean at most 3.5e-5 of the scale one frame from an equal carry, 1.4e-4
over 8 frames), a wrong one moves nearly every value by rounding noise (at
least 9.3e-4 and 2.9e-3). `BF16_BOUNDS` sits between the two;
`tests/test_torch_reduced_precision.py` (whose `main` prints these figures,
at 1, 8 and 37 streams) and `chip_smoke.py` show that `Float64Sums` and
`TensorCoreSums` (the order in which the CUDA kernel's bfloat16 builds sum on
the tensor cores) meet it and each of `WRONG` exceeds it.

    errs = cell_errors(cell_process(x, c, W, st), cell_process_plain(x, c, W, st))
    bad = out_of_bounds(errs, BF16_BOUNDS["frames"])      # [] if it passes
    errs = frame_by_frame(lambda x1, c1: cell_process(x1, c1, W, st), x, c, W, st)
    bad = out_of_bounds(errs, BF16_BOUNDS["one frame"])
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from deepfilternet_torch.ops.whole_cell import CKEYS, _Products, cell_process_plain, geometry_of

# (largest error, mean error) a bfloat16 kernel may have against the plain
# version, fractions of each output's largest value: each frame from the
# carry the plain version reaches there (`frame_by_frame`), and several
# frames running on from their own carries
BF16_BOUNDS = {"one frame": (5e-2, 2e-4), "frames": (0.1, 5e-4)}


class Float64Sums(_Products):
    """A right kernel that sums in another order: the same rounding points,
    each sum exact (float64) before its one rounding to float32."""

    def mmf(self, x: torch.Tensor, k: str) -> torch.Tensor:
        return (x.to(self.dtype).double() @ self.w[k].double()).float()


def _truncated_f32(v: torch.Tensor) -> torch.Tensor:
    """float64 values cut to float32 toward zero."""
    r = v.float()
    over = r.double().abs() > v.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


class TensorCoreSums(_Products):
    """A right kernel that sums as the bfloat16 builds do on the tensor cores
    (`mma.sync` m16n8k16, bfloat16 x bfloat16 -> float32): the 16 products of
    a k16 step summed exactly; up to `CHAIN` steps (one 64-row chunk of K,
    counted from the start of the product) accumulated from zero in float32,
    each add cut toward zero as the tensor core's accumulating add is; the
    chunks' sums joined by float32 adds rounded to nearest, in chunk order.
    The rows design sums so; the units design's chains are one step long,
    which truncates less."""

    CHAIN = 4

    def mmf(self, x: torch.Tensor, k: str) -> torch.Tensor:
        xr, w = x.to(self.dtype).double(), self.w[k].double()
        s, n, pad = xr.shape[0], w.shape[1], -xr.shape[1] % (16 * self.CHAIN)
        xr = torch.nn.functional.pad(xr, (0, pad))
        w = torch.nn.functional.pad(w, (0, 0, 0, pad))
        steps = torch.einsum("sck,ckn->scn", xr.reshape(s, -1, 16), w.reshape(-1, 16, n))
        steps = steps.reshape(s, -1, self.CHAIN, n)
        acc = torch.zeros_like(steps[:, :, 0])
        for i in range(self.CHAIN):
            acc = _truncated_f32(acc + steps[:, :, i]).double()
        total = acc[:, 0].float()
        for c in range(1, acc.shape[1]):
            total = total + acc[:, c].float()
        return total


RIGHT = (Float64Sums, TensorCoreSums)


class Unrounded(_Products):
    """Wrong: bfloat16 weights, but no input or result rounded."""

    def mmf(self, x: torch.Tensor, k: str) -> torch.Tensor:
        return x.float() @ self.w[k]

    def mm(self, x: torch.Tensor, k: str) -> torch.Tensor:
        return self.mmf(x, k)


class ResultsUnrounded(_Products):
    """Wrong: inputs rounded, but the trunk's results (`mm`) kept in float32."""

    def mm(self, x: torch.Tensor, k: str) -> torch.Tensor:
        return self.mmf(x, k)


class FloatResultsRounded(_Products):
    """Wrong: the results `mmf` keeps in float32 rounded to bfloat16 too."""

    def mmf(self, x: torch.Tensor, k: str) -> torch.Tensor:
        return super().mmf(x, k).to(self.dtype).float()


WRONG = (Unrounded, ResultsUnrounded, FloatResultsRounded)


def cell_errors(got, ref) -> Dict[str, Tuple[float, float]]:
    """{output: (largest, mean absolute error over the reference's largest
    value)} of two `cell_process` results (carry, audio), over the audio and
    the 11 carry arrays (at any geometry)."""
    (got_c, got_a), (ref_c, ref_a) = got, ref
    pairs = [("audio", got_a, ref_a)] + [(k, got_c[k], ref_c[k]) for k, _ in CKEYS]
    errs = {}
    for name, a, b in pairs:
        if a.shape != b.shape or not bool(torch.isfinite(a).all()):
            raise ValueError(f"{name}: shape {tuple(a.shape)} or non-finite values")
        diff = (a.float() - b.float()).abs()
        scale = max(float(b.abs().max()), 1e-30)
        errs[name] = (float(diff.max()) / scale, float(diff.mean()) / scale)
    return errs


def frame_by_frame(step, audio, carry, weights, statics) -> Dict[str, Tuple[float, float]]:
    """`step(frame, carry)` (a kernel launch or a plain variant, returning
    (carry, audio)) on each frame of `audio`, each from the carry the plain
    version reaches before it, against the plain version's frame: the
    `cell_errors` of each output, the worst over the frames."""
    worst: Dict[str, Tuple[float, float]] = {}
    hop = geometry_of(weights, statics).hop
    for f in range(audio.shape[1] // hop):
        x1 = audio[:, f * hop: (f + 1) * hop].contiguous()
        ref = cell_process_plain(x1, carry, weights, statics)
        for k, (e, m) in cell_errors(step(x1, carry), ref).items():
            e0, m0 = worst.get(k, (0.0, 0.0))
            worst[k] = (max(e0, e), max(m0, m))
        carry = ref[0]
    return worst


def out_of_bounds(errs: Dict[str, Tuple[float, float]], bounds: Tuple[float, float]
                  ) -> List[str]:
    """The outputs whose largest or mean error exceeds `bounds`."""
    top, mean = bounds
    return [k for k, (e, m) in errs.items() if not (e <= top and m <= mean)]


def worst(errs: Dict[str, Tuple[float, float]]) -> Tuple[float, float]:
    """(largest, mean) error over all outputs."""
    return max(e for e, _ in errs.values()), max(m for _, m in errs.values())
