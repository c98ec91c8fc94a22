"""K2's time a call in the stages of the `dsp` family, from its own records
(`benchmark/k2_records.py`)."""

from benchmark import k2_records


def read(ctx):
    return k2_records.family_ms("dsp")
