"""The stream cell at DFN3-ll's geometry (`dfn3_ll.stream_s4096`), driven on
the CPU at a small size: a sound run is correct, and each of the stream
kind's faults (a state handed back unchanged, half the batch left out, one
sample altered) makes it false."""

import time

import pytest

from benchmark import harness
from benchmark.traffic import stream as stream_kind

CELL = "dfn3_ll.stream_s4096"
SMALL = dict(streams=8, frames=6, pool=2, sample_every=4, keep_every=2, ref_rows=4,
             fixed_calls=3)


def _run(fault):
    return harness.run(CELL, 3141592653, 0.4, False, time.perf_counter(), device="cpu",
                       params=SMALL, fault=fault)


def test_sound_run_is_correct():
    r = _run(None)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] == 3 * SMALL["streams"]
    assert "stream_rtf" in r["metrics"] and "setup_s" in r["metrics"]


@pytest.mark.parametrize("fault", sorted(stream_kind.FAULTS))
def test_fault_is_caught(fault):
    assert not _run(fault)["correct"]
