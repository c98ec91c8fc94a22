"""The float8 control (`tools/control_fp8.py`) on the CPU at a small size:
the control's own frames are rounded to float8 e4m3, and the cell's check
still computes its reference in float32, so the control reads a gap."""

import torch

from benchmark import common, harness
from benchmark.reference import stream as reference
from benchmark.tools import control_fp8

CELL = "dfn3.stream_s4096"
SMALL = dict(streams=8, frames=6, pool=2, sample_every=4, keep_every=2, ref_rows=4)
CALLS = 3
# beside 256 (the tensor's largest, scaled to e4m3's 448), 1 + 2**-10 is
# 1.75 + 2**-10 * 1.75, which e4m3's 3 bits of mantissa round to 1.75; in
# float32 the product is exact
PROBE = 1.0 + 2.0 ** -10


def _probe_rounded():
    got = torch.matmul(torch.tensor([[PROBE, 256.0]]), torch.tensor([[1.0], [0.0]]))
    return float(got) != PROBE


def test_fp8_rounds_a_product():
    with control_fp8.Fp8Products():
        assert _probe_rounded()
    assert not _probe_rounded()


def test_control_rounds_its_frames_and_not_the_checks(monkeypatch):
    seen = []
    plain = reference.stream_block

    def spy(*args, **kwargs):  # the check's reference: unrounded
        seen.append(_probe_rounded())
        return plain(*args, **kwargs)

    monkeypatch.setattr(reference, "stream_block", spy)
    spec = harness.load_cell(CELL)
    spec["params"].update(SMALL)
    checks, _ = control_fp8.fp8_stream_control(spec, common.load_config(spec["config"]), 17,
                                               CALLS, torch.device("cpu"))
    assert seen and not any(seen)
    assert checks["audio_err"][0] > 1e-3 and checks["carry_err"][0] > 1e-3, checks
