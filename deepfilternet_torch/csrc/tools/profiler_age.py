"""How many of the card's kernel records torch.profiler keeps as a process
ages: a profiled loop of 20 K1 launches and 20 torch.mm launches (with 0.1 s
of idle host time on each side), counted by kernel, at the start and after
each of chip_smoke.py's phases 12 (the export, the demo trainers), 13 and
14, then after 120 s idle; once with the device activity alone and once
with the host's too. Not part of the package's build. On a machine with the
card, from the repository's root:

    python3 deepfilternet_torch/csrc/tools/profiler_age.py
"""
import os
import subprocess
import sys
import tempfile
import time


def main():
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from deepfilternet_torch import kernels
    from deepfilternet_torch.ops.fused_frontend import fused_analysis_frontend as k1f

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    kernels.build()
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    rng = np.random.default_rng(7)
    mem, mean, unit = cs.k1_state(dev, 64, cs.K1_DEFAULT, rng)
    args = [mem, cs.k1_frame(dev, 64, 480, rng), mean, unit]
    a = torch.randn(256, 256, device=dev)
    t_start = time.perf_counter()

    def probe(tag):
        res = []
        for acts in ([ProfilerActivity.CUDA], [ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.cuda.synchronize()
            with profile(activities=acts) as prof:
                time.sleep(0.1)
                for _ in range(20):
                    k1f(*args)
                    torch.mm(a, a)
                torch.cuda.synchronize()
                time.sleep(0.1)
            ev = prof.events()
            dev_ev = [e for e in ev if e.device_type == torch.autograd.DeviceType.CUDA]
            nk1 = sum("fused_frontend" in e.name for e in dev_ev)
            res.append(f"{len(acts)} activities: K1 {nk1}, other device {len(dev_ev) - nk1}, "
                       f"host events {len(ev) - len(dev_ev)}")
        print(f"PROBE {tag} at {time.perf_counter() - t_start:.0f} s: " + "; ".join(res),
              flush=True)

    probe("start")
    audio = cs.noisy_speech_like(64, cs.SECONDS, seed=0)
    with tempfile.TemporaryDirectory() as root:
        cs.export_path(root)
        probe("after export_path")
        cs.demo_training_path(root, audio)
        probe("after demo_training_path")
    cs.latest_corpus_path()
    probe("after phase 13")
    cs.hdf5_edit_path()
    probe("after phase 14")
    time.sleep(120)
    probe("after 120 s idle")


if __name__ == "__main__":
    main()
