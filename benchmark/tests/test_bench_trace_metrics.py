"""The readers of the program's spans and K2's stage records, on a made-up
trace and made-up records; each reads nothing where the program left
nothing to read (a program without the spans or records)."""

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import harness
from benchmark.trace import Trace

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def reader(name):
    return harness.load_module(METRICS / f"{name}.py").read


# two blocks, stages (gru, conv, dsp, wait) in ns; block 0 runs 0-1000 us,
# block 1 100-900 us of the call
RECORD = dict(design="units", stages=("a", "b", "c", "w"),
              families=("gru", "conv", "dsp", "wait"), frames=10,
              ns=np.array([[600_000, 200_000, 150_000, 50_000],
                           [400_000, 300_000, 100_000, 0]], np.int64),
              span=np.array([[0, 1_000_000], [100_000, 900_000]], np.int64))


@pytest.fixture
def records(monkeypatch):
    from deepfilternet_torch.utils import timings

    calls = [RECORD, dict(RECORD, ns=RECORD["ns"] * 2)]
    monkeypatch.setattr(timings, "k2_records", lambda: calls)


def test_k2_sm_busy(records):
    assert reader("k2_sm_busy_pct.stream")(None) == pytest.approx(100 * 1800 / 2000)


@pytest.mark.parametrize("family, ms", [("gru", 0.75), ("conv", 0.375), ("dsp", 0.1875)])
def test_k2_family_ms(records, family, ms):
    # a call's mean over blocks, averaged over the two calls (the second twice the first)
    assert reader(f"k2_{family}_ms.stream")(None) == pytest.approx(ms)


@pytest.mark.parametrize("name", ["k2_sm_busy_pct.stream", "k2_gru_ms.stream",
                                  "k2_conv_ms.stream", "k2_dsp_ms.stream"])
def test_k2_readers_without_records(monkeypatch, name):
    from deepfilternet_torch.utils import timings

    monkeypatch.setattr(timings, "k2_records", lambda: [])
    assert reader(name)(None) is None
    monkeypatch.delattr(timings, "k2_records")  # a program that keeps none
    assert reader(name)(None) is None


def stream_trace():
    host = [("whole_cell.process", 0.0, 0.010), ("k2.alloc", 0.001, 0.004),
            ("k2.launch", 0.004, 0.006), ("whole_cell.process", 0.5, 0.503),
            ("k2.launch", 0.501, 0.502), ("aten::empty", 0.001, 0.002)]
    return Trace([("whole_cell_kernel", 0.006, 0.49)], host, 1.0)


def test_runtime_glue():
    ctx = SimpleNamespace(trace=stream_trace())
    assert reader("runtime_glue_ms.stream")(ctx) == pytest.approx((8.0 + 2.0) / 2)
    ctx = SimpleNamespace(trace=Trace([], [("aten::empty", 0.0, 0.1)], 1.0))
    assert reader("runtime_glue_ms.stream")(ctx) is None


def offline_trace():
    dev = [("Memcpy HtoD", 0.012, 0.020), ("gemm", 0.030, 0.040), ("gemm", 0.050, 0.060),
           ("Memcpy DtoH", 0.075, 0.090)]
    host = [("enhance", 0.0, 0.1), ("enhance.pad", 0.0, 0.010), ("enhance.h2d", 0.010, 0.020),
            ("enhance.features", 0.020, 0.025), ("enhance.forward", 0.025, 0.065),
            ("enhance.synthesis", 0.065, 0.070), ("enhance.d2h", 0.070, 0.095),
            ("enhance.trim", 0.095, 0.1)]
    return Trace(dev, host, 0.1)


def test_forward_idle():
    ctx = SimpleNamespace(trace=offline_trace(), traced_calls=1)
    # forward 25-65 ms, busy 30-40 and 50-60: idle 20 of 40
    assert reader("forward_idle_pct.batch")(ctx) == pytest.approx(50.0)


def test_io_idle():
    ctx = SimpleNamespace(trace=offline_trace(), traced_calls=2)
    # pad 10 idle, h2d 2 idle (10-12), d2h 10 idle (70-75, 90-95), trim 5 idle: 27 ms, 2 calls
    assert reader("io_idle_ms.batch")(ctx) == pytest.approx(27.0 / 2)


@pytest.mark.parametrize("name", ["forward_idle_pct.batch", "io_idle_ms.batch"])
def test_offline_readers_without_spans(name):
    ctx = SimpleNamespace(trace=Trace([("gemm", 0.0, 0.01)], [("aten::mm", 0.0, 0.01)], 0.1),
                          traced_calls=2)
    assert reader(name)(ctx) is None
    assert reader(name)(SimpleNamespace(trace=None, traced_calls=2)) is None
