"""The lower-precision control on the card: the reference with TF32
products and convolutions in the program's place fails a check that sound
runs of the program pass. At a size a test run holds; `tools/control.py`
reads it at each cell's own size."""

import pytest
import torch

from benchmark import common, harness
from benchmark.tools import control

SMALL = {
    "dfn3.stream_s4096": (dict(streams=256, sample_every=16, keep_every=2, ref_rows=256), 4),
    "dfn2.offline_b16x10s": (dict(rows=4), 3),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_fails(card, cell):
    spec = harness.load_cell(cell)
    params, count = SMALL[cell]
    spec["params"].update(params)
    fn = {"stream": control.stream_control, "offline": control.offline_control}[spec["kind"]]
    checks, _ = fn(spec, common.load_config(spec["config"]), 17, count, card)
    assert any(v > lim for v, lim in checks.values()), checks
