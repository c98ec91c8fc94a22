"""The stopwatches of the A/B tools beside this file (`k1_ab.py`,
`k2_ab.py`): a call's time on the card from CUDA events or from
torch.profiler's kernel records, and the registers and spills `ptxas -v`
reports. The tools import it as a sibling module; the package and the card
check (`chip_smoke.py`) never do. Not part of the package's build."""

import re
import time

import torch

PROFILE_PAD_S = (0.1, 1.0)  # idle host time around a profiled loop, and on a retake


def time_ms(fn, iters=20):
    """Device time per call, CUDA events around `iters` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_device_ms(fn, match, iters=20):
    """Device time a launch of the kernels whose name holds `match`, from
    torch.profiler's kernel records, summed over the records and divided by
    their count (a host-bound loop of launches leaves gaps that CUDA events
    around the loop count in). The profiler keeps only the records it places
    inside its window, and places the card's 1-11 ms after the host's clock:
    the launches are padded with idle host time on both sides. A window with
    another number of records than launches is taken again with longer
    padding, and then raises. Prints where the first record lay against the
    host's first launch."""
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    for pad in PROFILE_PAD_S:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            with record_function("launches"):
                for _ in range(iters):
                    fn()
            torch.cuda.synchronize()
            time.sleep(pad)
        events = prof.events()
        hits = [e for e in events if e.device_type == cuda and match in e.name]
        host = [e.time_range.start for e in events if e.name == "launches"]
        lead = (min(e.time_range.start for e in hits) - host[0]) if hits and host else None
        print(f"  torch.profiler: {len(hits)} of {iters} {match} launches recorded "
              f"(padding {pad} s), the first "
              + ("not placed" if lead is None else f"{lead / 1e3:+.3f} ms")
              + " from the host's first launch")
        if len(hits) == iters:
            return sum(e.device_time_total for e in hits) / len(hits) / 1e3
    raise RuntimeError(f"torch.profiler recorded {len(hits)} of {iters} launches of {match}")


def ptxas_report(log, kernel):
    """'function build: N registers, spills' for each function whose name
    starts with `kernel` in a `-Xptxas -v` log (the function, e.g.
    whole_cell_kernel, whole_cell_recording, the build that times its stages,
    or a device function such as gemm, which has no register count of its
    own; then the stream rows of a rows kernel's tile and the build named by
    its operand type)."""
    name, out = None, {}
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([^' ]+)", line)
        if m:
            name = m.group(1)
            continue
        if not name or kernel not in name:
            continue
        fn = re.search(r"\d+(%s[a-z_]*)" % re.escape(kernel), name)
        rows = re.search(r"ILi(\d+)E", name)
        short = (f"{fn.group(1) if fn else kernel}{f' rows {rows.group(1)}' if rows else ''} "
                 f"{'bfloat16' if 'bfloat16' in name else 'float32'}")
        entry = out.setdefault(short, ["", "spills not shown"])
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            entry[1] = f"{m.group(1)} B spill stores, {m.group(2)} B spill loads"
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry[0] = f"{m.group(1)} registers, "
    return [f"{short}: {regs}{spills}" for short, (regs, spills) in out.items()]
