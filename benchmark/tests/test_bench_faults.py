"""A run's check comes out false when the timed path is broken underneath,
once for each fault a cell can have: a step that hands its state back
unchanged, half of the batch left out, an answer altered where it is
produced. The look for a card is skipped; the rest of a run is driven on
the CPU at a small size."""

import time

import pytest

from benchmark import harness

SMALL = {
    "dfn3.stream_s4096": dict(streams=8, frames=4, pool=2, sample_every=4, keep_every=2,
                              ref_rows=4, fixed_calls=3),
    "dfn2.offline_b16x10s": dict(rows=2, seconds_a_clip=1.0, pool=2, keep_every=2,
                                 fixed_calls=3),
}
FAULTS = ("stale_state", "half_batch", "altered_output")


def _run(cell, fault):
    return harness.run(cell, 20260101, 0.4, False, time.perf_counter(), device="cpu",
                       params=SMALL[cell], fault=fault)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct(cell):
    r = _run(cell, None)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_fault_is_caught(cell, fault):
    r = _run(cell, fault)
    assert not r["correct"], r["checks"]
