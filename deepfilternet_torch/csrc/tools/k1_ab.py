"""K1 built from other sources beside the package's, timed in turns.

Each source given on the command line (another revision of
`csrc/fused_frontend.cu` with the same C interface, e.g. a parent commit's
unpacked by `git archive` into a directory `.gitignore` lists) is built
with the package's nvcc flags into its own library. At the default geometry
(960/480/32/96) and DFN3-ll's (480/240/32/48), for S = 64 and 4096, every
build runs through the package's wrapper on the same inputs, in turns over
ROUNDS rounds: its outputs against the package's build (bit for bit, or the
geometry refused), its device time alone (torch.profiler; every round's
reading is printed, and a round in which the profiler kept fewer records
than launches fails) and over back-to-back calls (CUDA events). Then each
build is held to the plain version at every geometry of `chip_smoke.py`'s
phase 15. Not part of the
package's build. On a machine with the card, from the repository's root:

    python3 deepfilternet_torch/csrc/tools/k1_ab.py PATH/fused_frontend.cu [...]
"""

import ctypes
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import timing  # noqa: E402
from deepfilternet_torch import kernels  # noqa: E402
from deepfilternet_torch.ops import fused_frontend as ff  # noqa: E402

ROUNDS = 6


def build(sources, out_dir):
    """{name: library} of the package's build and one for each source."""
    libs = {"package": kernels.load("fused_frontend")}
    os.makedirs(out_dir, exist_ok=True)
    for i, src in enumerate(sources):
        path = os.path.join(out_dir, f"libk1_ab_{i}.so")
        subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", path, src], check=True,
                       capture_output=True, text=True)
        libs[src] = ctypes.CDLL(path)
    return libs


def run_with(lib, fn):
    """fn() with the wrapper launching `lib`'s kernel; None if it refuses the
    geometry."""
    load = kernels.load
    kernels.load = lambda name: lib
    try:
        return fn()
    except RuntimeError as e:
        if "cudaError" not in str(e):
            raise
        return None
    finally:
        kernels.load = load


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    libs = build(sys.argv[1:], os.path.join(kernels.BUILD_DIR, "k1_ab"))
    for shape in (cs.K1_DEFAULT, cs.K1_LOW_LATENCY):
        kw = cs.k1_kwargs(shape)
        for s in (64, 4096):
            rng = np.random.default_rng(7)
            mem, mean, unit = cs.k1_state(dev, s, shape, rng)
            args = [mem, cs.k1_frame(dev, s, shape[1], rng), mean, unit]

            def call():
                return [o.clone() for o in ff.fused_analysis_frontend(*args, **kw)]

            ref = run_with(libs["package"], call)
            times = {name: [] for name in libs}
            for rnd in range(ROUNDS):
                for name in (list(libs) if rnd % 2 == 0 else list(libs)[::-1]):
                    lib = libs[name]
                    if run_with(lib, call) is None:
                        times[name] = None
                        continue
                    times[name].append((
                        run_with(lib, lambda: timing.kernel_device_ms(call, "fused_frontend")),
                        run_with(lib, lambda: timing.time_ms(call))))
            for name, t in times.items():
                tag = f"K1 {'/'.join(map(str, shape))} S={s} {name} on {smi}:"
                if t is None:
                    print(f"{tag} refused the geometry")
                    continue
                same = all(torch.equal(a, b) for a, b in zip(run_with(libs[name], call), ref))
                print(f"{tag} outputs bit for bit the package's: {same}; device alone ms "
                      + ", ".join(f"{d:.4f}" for d, _ in t)
                      + "; back to back ms " + ", ".join(f"{e:.4f}" for _, e in t))
    for name, lib in libs.items():
        try:
            worst = run_with(lib, lambda: max(cs.check_frontend_shape(dev, shape, (1, 37))
                                              for shape in cs.K1_SHAPES))
        except RuntimeError as e:  # chip_smoke.fail: a geometry outside the tolerance
            worst = f"failed ({e})"
        print(f"K1 {name} against its plain version at every phase-15 geometry, S=1 and 37: "
              f"{'refuses one or more' if worst is None else worst}")


if __name__ == "__main__":
    main()
