#!/usr/bin/env python3
"""Drive the PyTorch port (deepfilternet_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on any failed check:

  1. device  - needs CUDA; prints the card's name and power limit;
  2. build   - compiles every CUDA kernel from deepfilternet_torch/csrc/, and
               counts each kernel's tensor-core (HMMA) instructions; prints
               -Xptxas -v's registers and spills of the units design's float32
               and bfloat16 builds;
  3. kernels - each kernel against its plain PyTorch version on the card at
               the main path's shapes (and others), with its time, the plain
               version's, a library yardstick's (where one PyTorch call
               computes the same function) and the card's bound for the same
               work, at the main path's shape and at S=4096; the whole-cell
               kernel in both of its designs (every product cut over all
               multiprocessors; a tile of stream rows a block, built for 4 and
               8 rows, and 16 at bfloat16), also where a block walks over
               several units or tiles; every block's stage split from the
               kernel's records under the profiler (the units design's with
               each block's wait on producers), and 20 calls on the same inputs at
               S=64 x 200 and 512 x 30 equal bit for bit (a race between a
               unit and the counters it waits on would differ), float32 here
               and bfloat16 in phase 6;
  4. main    - streaming DFN3 with the bundled demo checkpoint: 64 streams
               x 2 s through StreamingRuntime.process (one frontend kernel
               launch per frame), held against the same run on the CPU, then
               enhance(backend="scan") on 16 x 2 s; then the same 64 x 2 s
               through WholeCellStreamingRuntime.process (one whole-cell
               kernel launch for all 200 frames), held against the per-frame
               run, the plain version on the CPU and itself in two calls; then
               the same runtime called one frame at a time (per-hop latency).
               The kernels' launch counts show each path went through its
               kernel. A short profiled run says where a per-frame frame's
               time goes;
  5. offline - enhance() with its default backend (the whole-utterance
               forward) on 16 x 10 s, held against the same 2 rows on the CPU
               and against backend="scan" on the card; the chunked runtime on
               the main path's 64 x 2 s, held against the per-frame output and
               against itself in two calls; the CLI once. These paths launch
               neither kernel (cuFFT, cuDNN and cuBLAS do their work), which
               the launch counts show. Wall times and RTF are information;
  6. reduced precision - the whole-cell kernel's bfloat16 build (on the
               tensor cores) against its plain bfloat16 version in both
               designs, and its times with their bounds; StreamingRuntime(dtype=bfloat16) on the main
               path's 64 x 2 s (K1 once a frame) against the same streams on
               the CPU, ChunkedStreamingRuntime(dtype=bfloat16), out_dtype;
               WholeCellStreamingRuntime with its default bfloat16 operands
               (one K2 launch, counted apart) against the per-frame bfloat16
               run, the float32 whole-cell run and itself in two calls, then
               one frame a call;
  7. serving - StreamServer on the card, 64 slots, each tick one replay of a
               CUDA graph that holds one K1 launch: 16 and then 64 concurrent
               StreamClients over localhost stream 2 s each, one hop a
               request, each held against StreamingRuntime.process of the
               same audio on the card (phase 4) at 1e-5; graph replays equal
               ticks, fewer than hops; the tick's device time
               (measure_chip_tick, S=16 and 64), host time a tick, per-hop
               round trip and hops a second beside the 10 ms hop; the server
               over data_parallel_mesh() equal to the unsharded one; the
               WebSocket bridge once (page, one hop);
  8. families - the DFN2 and DFN1 checkpoints (pretrained/dfn2_fixture_demo,
               dfn1_fixture_demo) loaded on the card by init_df: enhance()
               offline on [16, 2 s] against the CPU; StreamingRuntime on the
               main path's 64 x 2 s against the CPU, K1 launched once a frame
               and held against its plain version on the first frame;
               enhance(backend="scan") against the offline output; the
               chunked runtime against the per-frame output; DFN1 mask-only
               (offline and per frame) against the CPU; a 16-slot DFN2 server
               (K1 inside its graph) whose 4 clients in spawned processes
               equal StreamingRuntime.process bit for bit. Then
               DeepFilterNet-MF (seeded random weights at its default widths),
               WF and MVDR: enhance() on [4, 2 s], and the forward on the same
               features against the CPU;
  9. training - DFN3 from the demo checkpoint (init_model, read_cp) at its
               published widths, the fixture-demo losses and the
               multi-resolution loss: one train step on the card against the
               same step on the CPU (B=4 x 3 s; every GRU weight must get a
               gradient), 20 steps on one batch of 8 x 3 s (the loss must
               fall; step time, profile line, peak memory), a NaN batch that
               must change nothing, the trained weights through write_cp,
               config.save and init_df into enhance() and StreamingRuntime
               (K1 once a frame), a MASK_ONLY step; DFN2 and DFN1 from their
               checkpoints and MF with seeded weights, a step each against the
               CPU and 3 steps. Training launches neither kernel;
 10. corpus    - the data engine and train/run.py: the native data library
               built and held against scipy; speech (64 x 5 s), noise
               (32 x 10 s), RIR (8 x 0.5 s) and validation (16 x 5 s) corpora
               written by the port's prepare_data (its own HDF5 writer: the
               card's machine has no h5py) and read back bit for bit; one
               epoch of DataLoader(FdDataset(TdDataset)) at 1 and 4 workers,
               batch for batch equal, its features against the port's torch
               stft/erb_feat/spec_feat on the card; the first batch's step
               card vs CPU; train() from the demo checkpoint (as epoch 0) for
               an epoch, then a resumed epoch under the profiler, which must
               start after the newest epoch written (a best one). Step time
               inside train() against a batch held on the card, the host's
               time between steps, busy share, epoch wall, loader samples a
               second and peak memory are information; K1 and K2 read 0;
 11. evaluation - 16 seeded (noisy, clean) pairs of 5 s (speech-like, white
               and babble-like noise at 0-10 dB) scored by eval_dir on the
               card with DFN3 from the demo checkpoint and every metric (STOI,
               SI-SDR, SNRseg, fwSNRseg, LLR, WSS, PESQ wb and nb, composite)
               in a pool of 4 spawned workers, then on the CPU: the enhanced
               audio and each file's metrics held card against CPU, the CSV;
               the DNS naming; dnsmos raises; test_df writes goldens into a
               copy of the demo directory and asserts them on the card and on
               the CPU; libdf_compat card against CPU; hdf5_tool's five
               commands on a prepare_data corpus; model_summary. The metric
               pool's wall at 1 and 4 workers, enhance a file and the scoring
               rate are information; K1 and K2 read 0.
 12. DFN2/DFN1 at bfloat16, export, demo trainers - the per-frame and
               chunked bfloat16 runtimes of both families against the CPU (K1
               once a frame); scripts/export (torch.export) against eager;
               train_demo and overfit_trial over a seeded corpus; K1 and K2
               read 0 over the export and the trainers.
 13. newer HDF5 formats - the corpus h5py wrote with libver="latest"
               (deepfilternet_torch/data/testdata/: superblock 3, version-2
               object headers, fractal heaps, v2 B-trees, fixed-array chunk
               indexes, a noise group in creation order) read through H5File
               and Hdf5Dataset bit for bit against its MANIFEST.json, without
               h5py; each file copied into h5py's default format by H5Writer
               (copy_group: the chunks byte for byte, in h5py's chunks of
               3,163-5,867 samples)
               and both read back equal (read rates as information);
               hdf5_tool list, split and trim; prepare_data merging two WAVs
               into a copy in place; one loader epoch over each format,
               batches equal; the first batch's train step card vs CPU,
               train() for one epoch from the demo checkpoint and read_cp
               after it; K1 and K2 read 0; at most 60 s.
 14. in-place HDF5 edits - prepare_data writes a 512-clip corpus of 5 s
               seeded harmonic-plus-noise int16 speech (245.8 MB of samples),
               then merges 16 new 5 s WAVs in place (2 over keys already
               there): its wall time and the bytes the file grew by beside
               the old way's, timed inline (every clip read and written into
               a new file); every clip bit for bit through H5File and
               Hdf5Dataset, the old bytes outside the superblock unchanged;
               hdf5_tool fix in place (every chunk index entry as before);
               split and trim (raw chunk copies, byte for byte the source's;
               MB/s); two WAVs merged into a copy of the committed
               superblock-3 speech.hdf5 (phase 13's check: its manifest plus
               the new clips, still superblock 3); one loader epoch over the
               merged corpus;
               K1 and K2 read 0; at most 90 s.
 15. configuration matrix - BASELINE.json's configurations: K1 against its
               plain version at six geometries (fft/hop/ERB/DF 960/480/32/96,
               480/240/32/48, 960/480/24/64, 960/240/32/96, 480/236/32/48,
               480/238/32/48) for S = 1, 17, 37, 64, 4096, mem and frame also
               4 bytes off 16-byte alignment, timed at DFN3-ll's (480/240)
               with its bounds; a seeded DFN3 at FFT 480 / hop 240 / 48 DF bins (5 ms
               delay): StreamingRuntime.process on 64 x 2 s (400 frames, K1
               once a frame) against the CPU, at bfloat16, enhance(backend=
               "scan") on 16 x 2 s, a 16-slot server at hop 240 whose clients
               equal StreamingRuntime.process; DFN2 and DFN1 per frame at that
               configuration and DFN3 at 24 ERB / 64 DF bins, each against the
               CPU; DF_ORDER 1-5 per frame against the offline forward; the
               whole cell refuses the low-latency configuration (K2 reads 0);
               at most 120 s.
 16. the last slices - DFN3-ll (seeded weights at the default widths) trained
               on the card: one step against the CPU's (4 x 3 s, phase 9's
               bounds), 20 timed steps on 8 x 3 s, the stepped weights through
               write_cp, config.save and init_df into StreamingRuntime.process
               on 64 x 2 s (K1 once a frame, 400 frames) against the CPU;
               deepfilternet_torch/scripts/cuda_train.sh --device cuda for
               three epochs over a corpus of a few clips, SIGUSR1 to the
               trainer after its first epoch: continue holds that epoch, the
               wrapper resubmits once, the resumed run trains only the later
               epochs, exit 0 and no continue left; the port's make_vtlp_pool
               over 16 x 5 s at 4 warps (audio seconds a wall second), read
               back and fed to train_demo's loader as DEMO_EXTRA_CLEAN; K2
               reads 0; at most 150 s.

Phases 3 to 5 hold the whole cell at float32 operands
(matmul_dtype=torch.float32); phase 6 at bfloat16, the runtime's default.
K1's time on the device alone comes from torch.profiler's records of its
launches, taken in a new process (device_ms_fresh); a run in which the
profiler kept fewer records than launches fails (kernel_device_ms).
The second-to-last line of standard output is {"kernels": [...]}, the last
{"ok": true, "device": {...}}. TF32 and cuBLAS's reduced-precision bfloat16
reductions are off, so float32 runs are float32 against float32 and bfloat16
products sum in float32.
"""

import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

MODEL_DIR = "pretrained/dfn3_fixture_demo"
SR, HOP = 48000, 480
SECONDS = 2.0

# dense peaks (NVIDIA data sheets): float32 outside the tensor cores, TF32 and
# bfloat16 on them in FLOP/s, device memory in bytes/s; first match on the
# device name wins
PEAKS = (
    ("H100 PCIe", 51.2e12, 378e12, 756e12, 2.0e12),
    ("H100 NVL", 60.0e12, 418e12, 835e12, 3.9e12),
    ("H200", 67.0e12, 495e12, 989e12, 4.8e12),
    ("H100", 67.0e12, 495e12, 989e12, 3.35e12),
)


def fail(msg):
    raise RuntimeError(f"chip_smoke: {msg}")


def peaks(name):
    """(float32 FLOP/s, TF32 and bfloat16 tensor-core FLOP/s, bytes/s) of the
    card."""
    for key, flops, tf32, bf16, bw in PEAKS:
        if key in name:
            return flops, tf32, bf16, bw
    fail(f"no peak rates known for {name!r}")


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


def alternate(fns, rounds=3):
    """Median over `rounds` of each function's time, taken in turns."""
    times = {k: [] for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            times[k].append(time_ms(fn))
    return {k: float(np.median(v)) for k, v in times.items()}


def noisy_speech_like(n_streams, seconds, seed):
    """Harmonic tones with a slow vibrato plus white noise, per stream."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    f0 = rng.uniform(100.0, 300.0, (n_streams, 1))
    vib = 1.0 + 0.02 * np.sin(2 * np.pi * rng.uniform(2.0, 6.0, (n_streams, 1)) * t)
    phase = 2 * np.pi * f0 * np.cumsum(vib, axis=1) / SR
    speech = sum(np.sin(k * phase) / k for k in range(1, 6)) * 0.1
    noise = rng.standard_normal(speech.shape) * rng.uniform(0.01, 0.05, (n_streams, 1))
    return (speech + noise).astype(np.float32)


# -- phase 3: the fused analysis frontend (TPU kernel K1) --------------------


# K1's geometries (fft, hop, nb_erb, nb_df): the main path's, and those of
# phase 15's configuration matrix
K1_DEFAULT = (960, 480, 32, 96)
K1_LOW_LATENCY = (480, 240, 32, 48)  # DFN3-ll
K1_SHAPES = (K1_DEFAULT, K1_LOW_LATENCY,
             (960, 480, 24, 64),     # test_configs' ERB and DF counts
             (960, 240, 32, 96),     # 75% overlap: D != H
             (480, 236, 32, 48),     # D, H = 244, 236: not multiples of 32
             (480, 238, 32, 48))     # D, H = 242, 238: not multiples of 4


def k1_kwargs(shape):
    fft, hop, nb_erb, nb_df = shape
    return dict(fft_size=fft, hop_size=hop, nb_erb=nb_erb, nb_df=nb_df)


def k1_state(dev, s, shape, rng):
    """A seeded mid-stream K1 state: memory, ERB means around their init,
    unit norms in their init range."""
    from deepfilternet_torch.ops import mean_norm_init

    fft, hop, nb_erb, nb_df = shape
    return [torch.from_numpy(x).to(dev) for x in (
        (rng.standard_normal((s, fft - hop)) * 0.1).astype(np.float32),
        (mean_norm_init(nb_erb) + rng.standard_normal((s, nb_erb)) * 5).astype(np.float32),
        rng.uniform(1e-4, 1e-3, (s, nb_df)).astype(np.float32),
    )]


def k1_frame(dev, s, hop, rng):
    return torch.from_numpy((rng.standard_normal((s, hop)) * 0.1).astype(np.float32)).to(dev)


def library_frontend(mem, frame, mean, unit, cs, fb, nb_df, alpha):
    """Yardstick: one torch.matmul (cuBLAS) for both DFT products, then the
    same epilogue in torch. Timed here only; the port never calls it."""
    f = cs.shape[1] // 2
    buf = torch.cat([mem, frame], dim=-1)
    spec = torch.matmul(buf, cs)
    re, im = spec[:, :f], spec[:, f:]
    power = re * re + im * im
    erb_db = 10.0 * torch.log10(power @ fb + 1e-10)
    mn = erb_db * (1.0 - alpha) + mean * alpha
    un = torch.sqrt(power[:, :nb_df]) * (1.0 - alpha) + unit * alpha
    scale = torch.rsqrt(un)
    return (buf[:, frame.shape[1]:], re, im, (erb_db - mn) / 40.0, re[:, :nb_df] * scale,
            im[:, :nb_df] * scale, mn, un)


def unaligned(t):
    """`t` copied into a contiguous tensor whose first element lies 4 bytes
    past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    base = (1 - buf.data_ptr() // 4) % 4
    out = buf[base: base + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def check_frontend_shape(dev, shape, streams):
    """K1 against its plain version at one geometry, for each stream count
    over 3 chained frames, the second with mem and the third with the frame
    starting 4 bytes past a 16-byte boundary (the kernel's 4-byte build, as
    where fft - hop or hop is not a multiple of 4): every output within 1e-5
    of its largest value. Returns the largest absolute error."""
    from deepfilternet_torch.ops.fused_frontend import (
        fused_analysis_frontend,
        fused_analysis_frontend_plain,
    )

    names = ("new_mem", "spec_re", "spec_im", "feat_erb", "fc_re", "fc_im",
             "new_mean", "new_unit")
    kw = dict(k1_kwargs(shape), alpha=0.99)
    tag = "/".join(map(str, shape))
    worst = 0.0
    for s in streams:
        rng = np.random.default_rng(s)
        mem, mean, unit = k1_state(dev, s, shape, rng)
        for i in range(3):
            frame = k1_frame(dev, s, shape[1], rng)
            mem, frame = (unaligned(mem) if i == 1 else mem,
                          unaligned(frame) if i == 2 else frame)
            got = fused_analysis_frontend(mem, frame, mean, unit, **kw)
            ref = fused_analysis_frontend_plain(mem, frame, mean, unit, **kw)
            torch.cuda.synchronize()
            errs = []
            for name, a, b in zip(names, got, ref):
                if a.shape != b.shape or not torch.isfinite(a).all():
                    fail(f"K1 {tag} {name} at S={s}: shape {tuple(a.shape)} or non-finite values")
                err = float((a - b).abs().max())
                # 1e-5 of each output's largest value: the kernel sums the
                # fft-term products in another order than cuBLAS, from TF32
                # operand halves (hi + lo) whose lo * lo term it drops
                tol = 1e-5 * float(b.abs().max())
                if err > tol:
                    fail(f"K1 {tag} {name} at S={s}: max abs err {err:.3e} > tol {tol:.3e}")
                errs.append(f"{name}={err:.2e}/{tol:.2e}")
                worst = max(worst, err)
            mem, mean, unit = (ref[i].contiguous() for i in (0, 6, 7))
        print(f"K1 {tag} (fft/hop/ERB/DF) S={s}: max abs err / tol (1e-5 x max|plain|) over 3 "
              f"chained frames, mem then frame 4 bytes off 16-byte alignment (last frame): "
              + " ".join(errs))
    return worst


def check_frontend(dev, card):
    # 16 and 17: one full small tile, and its ragged edge; 37: ragged; 4096:
    # the large tile
    worst = check_frontend_shape(dev, K1_DEFAULT, (1, 16, 17, 37, 64, 4096))

    # timing: at the main path's shape (S=64, the kernels line) and at the
    # TPU reference's benchmark shape (S=4096)
    empty = empty_launch_ms()
    print(f"an empty kernel launch on {card}: {empty:.4f} ms a launch over 200 back-to-back "
          "launches (CUDA events), what any single launch costs at least")
    dev_ms = device_ms_fresh([(K1_DEFAULT, 64), (K1_DEFAULT, 4096)])
    t64 = time_frontend(dev, card, 64, empty, dev_ms[K1_DEFAULT, 64])
    time_frontend(dev, card, 4096, empty, dev_ms[K1_DEFAULT, 4096])
    return dict(name="fused_analysis_frontend", route="cuda",
                source="deepfilternet_torch/csrc/fused_frontend.cu",
                replaces="deepfilternet_tpu/ops/pallas_frontend.py:37",
                launches=None, max_abs_err=worst, **t64)


def empty_launch_ms():
    """Device time of an empty kernel launched back to back through ctypes,
    as the kernels are."""
    from deepfilternet_torch.kernels import load
    from deepfilternet_torch.ops.fused_frontend import _bind

    lib = _bind(load("fused_frontend"))
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        if lib.dfn_empty_launch(stream) != 0:
            fail("the empty kernel did not launch")

    return time_ms(launch, iters=200)


PROFILE_PAD_S = (0.1, 1.0)  # idle host time around a profiled loop, and on a retake


def kernel_device_ms(fn, match, iters=20):
    """Device time a launch of the kernels whose name holds `match`, from
    torch.profiler's kernel records, summed over the records and divided by
    their count (a host-bound loop of launches leaves gaps that CUDA events
    around the loop count in). The profiler keeps only the records it places
    inside its window, and places the card's 1-11 ms after the host's clock:
    the launches are padded with idle host time on both sides. A window with
    another number of records than launches is taken again with longer
    padding, and then fails. Prints where the first record lay against the
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
    fail(f"torch.profiler recorded {len(hits)} of {iters} launches of {match}")


def device_ms_child():
    """In a process of its own: K1's device time alone (kernel_device_ms) for
    each (shape, S) given as JSON in argv[1], on time_frontend's inputs;
    prints the times as JSON on the last line."""
    from deepfilternet_torch.ops.fused_frontend import fused_analysis_frontend

    dev, out = torch.device("cuda"), []
    for shape, s in json.loads(sys.argv[1]):
        kw = dict(k1_kwargs(shape), alpha=0.99)
        rng = np.random.default_rng(7)
        mem, mean, unit = k1_state(dev, s, shape, rng)
        args = [mem, k1_frame(dev, s, shape[1], rng), mean, unit]
        out.append(kernel_device_ms(lambda: fused_analysis_frontend(*args, **kw),
                                    "fused_frontend"))
    print(json.dumps(out))


def device_ms_fresh(cases):
    """{(shape, S): K1's device time alone} from device_ms_child in a new
    process. torch.profiler loses a growing share of the card's kernel
    records as a process ages (every record of a 20-launch window 9 s into a
    process, 15-20 of 20 after 48-235 s, none after about 600 s of this
    script; PERF.md §7), so the time does not depend on what ran before."""
    here = os.path.dirname(os.path.abspath(__file__))
    cases = [(tuple(shape), s) for shape, s in cases]
    res = subprocess.run(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.device_ms_child()",
         json.dumps(cases)], cwd=here, capture_output=True, text=True, timeout=300)
    lines = res.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(line)
    if res.returncode != 0 or not lines:
        fail(f"K1's device time in a new process failed: {res.stderr.strip()[-2000:]}")
    return dict(zip(cases, json.loads(lines[-1])))


def time_frontend(dev, card, s, empty_ms, dev_ms, shape=K1_DEFAULT):
    """K1's time per frame at S streams beside its plain version, the
    library yardstick and the card's bounds for the same work; `dev_ms` is
    its device time alone (device_ms_fresh)."""
    from deepfilternet_torch.ops import erb_fb_tensor, erb_widths
    from deepfilternet_torch.ops.fused_frontend import (
        fused_analysis_frontend,
        fused_analysis_frontend_plain,
    )
    from deepfilternet_torch.ops.stft import dft_matrices

    fft, hop, nb_erb, nb_df = shape
    alpha = 0.99
    kw = dict(k1_kwargs(shape), alpha=alpha)
    rng = np.random.default_rng(7)
    mem, mean, unit = k1_state(dev, s, shape, rng)
    args = [mem, k1_frame(dev, s, hop, rng), mean, unit]
    cs = torch.tensor(np.concatenate(dft_matrices(fft, hop), axis=1), device=dev)
    fb = erb_fb_tensor(erb_widths(SR, fft, nb_erb, 2), dev)
    t = alternate({
        "kernel": lambda: fused_analysis_frontend(*args, **kw),
        "plain": lambda: fused_analysis_frontend_plain(*args, **kw),
        "library": lambda: library_frontend(*args, cs, fb, nb_df, alpha),
    })
    f, n, d = fft // 2 + 1, fft, fft - hop
    flops = 2 * s * n * 2 * f + 2 * s * f * nb_erb
    nbytes = 4 * (s * (d + hop + nb_erb + nb_df)                    # inputs
                  + s * (d + 2 * f + 2 * nb_erb + 3 * nb_df)         # outputs
                  + 2 * n * f + f * nb_erb)                          # DFT + ERB matrices
    peak_flops, peak_tf32, _, peak_bw = peaks(card)
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
    bound_ms = max(t_ops, t_bytes)
    # the kernel's products run on the tensor cores as three TF32 passes: the
    # bound of the unit it uses is three times the operations at the TF32 rate
    t_tc = 3 * flops / peak_tf32 * 1e3
    unit_bound = max(t_tc, t_bytes)
    best = min(t["kernel"], dev_ms)
    tag = "" if shape == K1_DEFAULT else f" at {'/'.join(map(str, shape))} (fft/hop/ERB/DF)"
    print(f"K1{tag} S={s} per frame on {card}: kernel {t['kernel']:.4f} ms over back-to-back calls "
          f"(CUDA events), {dev_ms:.4f} ms on the device alone (profiler), plain "
          f"{t['plain']:.4f} ms, library {t['library']:.4f} ms, an empty launch {empty_ms:.4f} ms "
          f"({best / empty_ms:.1f} empty launches); float32 bound {bound_ms:.4f} ms "
          f"({flops / 1e9:.3f} GFLOP at {peak_flops / 1e12:.1f} TFLOP/s float32 = {t_ops:.4f} ms; "
          f"{nbytes / 1e6:.2f} MB at {peak_bw / 1e12:.2f} TB/s = {t_bytes:.4f} ms); bound of the "
          f"unit the kernel uses {unit_bound:.4f} ms (3 TF32 passes at "
          f"{peak_tf32 / 1e12:.0f} TFLOP/s = {t_tc:.4f} ms, or the bytes); kernel at "
          f"{min(unit_bound / best, 1.0):.1%} of that bound, "
          f"{min(bound_ms / best, 1.0):.1%} of the float32 one")
    return dict(ms=t["kernel"], plain_ms=t["plain"], bound_ms=bound_ms,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                library_ms=t["library"], device_ms=dev_ms, tensor_bound_ms=unit_bound,
                empty_launch_ms=empty_ms)


# -- phase 3: the whole-cell kernel (TPU kernel K2) --------------------------

K2_RUNTIME_STAGES = dict(atten_lim_db=12.0, post_filter_beta=0.02, lsnr_gating=True)


def seeded_audio(s, frames, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        (rng.standard_normal((s, frames * HOP)) * scale).astype(np.float32))


def compare_cell(tag, got, ref, rel_tol, mean_tol=None):
    """Every output of the whole cell (audio and the 11 carry arrays) against
    the reference: its largest absolute error within rel_tol of the
    reference's largest value, and, if mean_tol is given, its mean absolute
    error within mean_tol of it. Returns the largest absolute error and the
    largest of either kind over the output's largest value."""
    worst = worst_rel = worst_mean = 0.0
    for name, b in ref.items():
        a = got[name]
        if a.shape != b.shape or not torch.isfinite(a).all():
            fail(f"K2 {tag} {name}: shape {tuple(a.shape)} or non-finite values")
        diff = (a - b).abs()
        err, mean = float(diff.max()), float(diff.mean())
        scale = float(b.abs().max())
        if err > rel_tol * scale:
            fail(f"K2 {tag} {name}: max abs err {err:.3e} > tol {rel_tol * scale:.3e}")
        if mean_tol is not None and mean > mean_tol * scale:
            fail(f"K2 {tag} {name}: mean abs err {mean:.3e} > tol {mean_tol * scale:.3e}")
        worst = max(worst, err)
        worst_rel = max(worst_rel, err / max(scale, 1e-30))
        worst_mean = max(worst_mean, mean / max(scale, 1e-30))
    return worst, worst_rel, worst_mean


@contextlib.contextmanager
def k2_design(design, rows=None):
    """Inside the block `cell_process` launches the named design of the kernel
    ("units": every product cut over all multiprocessors; "rows": a tile of
    stream rows a block, with `rows` 4, 8 or (bfloat16) 16 a block) whatever S
    is, so that
    every build can be checked and timed at one S. None leaves the wrapper's
    own choice."""
    from deepfilternet_torch.ops import whole_cell

    own = whole_cell._kernel_choice, whole_cell._tile_rows
    if design is not None:
        whole_cell._kernel_choice = lambda *args: design
    if rows is not None:
        whole_cell._tile_rows = lambda *args: rows
    try:
        yield
    finally:
        whole_cell._kernel_choice, whole_cell._tile_rows = own


def own_k2_design(s, bf16):
    """(design, rows a block or None) the wrapper picks at S streams for the
    float32 or the bfloat16 build."""
    from deepfilternet_torch.ops.whole_cell import _kernel_choice, _tile_rows

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    design = _kernel_choice(s, n_sm, bf16)
    return design, (_tile_rows(s, n_sm, bf16) if design == "rows" else None)


def design_name(design, rows):
    return "units" if design == "units" else f"rows, {rows} a block"


# (streams, frames compared, design, rows a block; None: the wrapper's choice:
# "units" up to 8 tiles of 64 streams on 132 multiprocessors, else "rows" with
# 4 rows up to 4 x the card's multiprocessors, else 8, or 16 for bfloat16
# beyond 8 x). 1100 streams are 18 tiles of 64 (the last ragged), 138 of 8,
# 69 of 16 and 275 of 4: more units or tiles than blocks in every design but
# 16 rows, so a block walks over several.
K2_CASES = ((1, 8, None, None), (37, 8, None, None), (64, 8, None, None),
            (37, 8, "rows", 4), (64, 8, "rows", 8), (1100, 2, None, None),
            (1100, 2, "rows", 4), (1100, 2, "units", None))
# the bfloat16 build's 16 rows a block (two n8 tiles of the tensor cores)
K2_BF16_CASES = ((37, 8, "rows", 16), (64, 8, "rows", 16), (1100, 2, "rows", 16))


def k2_bounds(dtype):
    """Kernel against plain version: {"one frame": (largest, mean error),
    "frames": ...}, fractions of each output's largest value, for each frame
    from the plain version's carry and for several running on from the same
    carry (mean None: not bounded). float32:
    1e-4, the kernel adds its sums of up to 2048 terms in another order than
    cuBLAS, through ~45 layers and three recurrences, over 8 frames.
    bfloat16: `whole_cell_check.BF16_BOUNDS`, which a right kernel summing in
    another order meets and a kernel that skips or misplaces the bfloat16
    rounding does not (checked on the card by `check_bf16_bounds`)."""
    if dtype == torch.float32:
        return {"one frame": (1e-4, 1e-4), "frames": (1e-4, None)}
    from deepfilternet_torch.ops.whole_cell_check import BF16_BOUNDS

    return BF16_BOUNDS


def check_bf16_bounds(tag, x, carry, W, st):
    """The plain version with products that sum in another order (float64;
    the tensor cores' order of the kernel's bfloat16 builds) and with each
    wrong rounding of `whole_cell_check`, against the plain version, each
    frame from the plain version's carry and all frames from `carry`: the
    right ones must stay within BF16_BOUNDS, every wrong one must exceed them
    in both spans."""
    from deepfilternet_torch.ops import whole_cell_check as wcc
    from deepfilternet_torch.ops.whole_cell import cell_process_plain

    readings = []
    ref = cell_process_plain(x, carry, W, st)
    for products in wcc.RIGHT + wcc.WRONG:
        right = products in wcc.RIGHT
        variant = lambda x1, c1: cell_process_plain(x1, c1, W, st, products)  # noqa: E731
        for span, errs in (("one frame", wcc.frame_by_frame(variant, x, carry, W, st)),
                           ("frames", wcc.cell_errors(variant(x, carry), ref))):
            bad = wcc.out_of_bounds(errs, wcc.BF16_BOUNDS[span])
            if right == bool(bad):
                fail(f"K2 bfloat16 bounds ({tag}): {products.__name__} {span} "
                     f"{'exceeds' if right else 'meets'} {wcc.BF16_BOUNDS[span]}: {errs}")
            top, mean = wcc.worst(errs)
            readings.append(f"{products.__name__} {span} {top:.2e} / {mean:.2e}")
    print(f"K2 bfloat16 bounds {dict(wcc.BF16_BOUNDS)} ({tag}), plain variants against the "
          "plain version on the card (largest / mean error of the worst output): "
          + "; ".join(readings) + f"; {', '.join(c.__name__ for c in wcc.RIGHT)} within, "
          + ", ".join(c.__name__ for c in wcc.WRONG) + " beyond in both spans")


def dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def check_whole_cell(dev, card, model, df_state, dtype):
    """K2 at `dtype` operands against its plain version in every design, from
    a non-initial carry, with and without the runtime stages. Returns (the
    largest absolute error, a runtime at `dtype` with default params)."""
    from deepfilternet_torch.ops.whole_cell import cell_process, cell_process_plain
    from deepfilternet_torch.ops.whole_cell_check import frame_by_frame, out_of_bounds
    from deepfilternet_torch.ops.whole_cell_check import worst as worst_errs
    from deepfilternet_torch.streaming import RuntimeParams
    from deepfilternet_torch.streaming_whole_cell import (
        WholeCellStreamingRuntime,
        carry_to_flat,
    )

    def outputs(res):
        carry, audio = res
        return dict(carry, audio=audio)

    bounds = k2_bounds(dtype)
    bf16 = dtype == torch.bfloat16
    tol_max, tol_mean = bounds["frames"]
    worst = 0.0
    for stages in ({}, K2_RUNTIME_STAGES):
        rt = WholeCellStreamingRuntime(model, df_state, RuntimeParams(**stages),
                                       matmul_dtype=dtype)
        W, st = rt.weights, rt.statics
        label = f"{dtype_name(dtype)}, " + ("runtime stages on" if stages else "default params")
        for s, frames, design, rows in K2_CASES + (K2_BF16_CASES if bf16 else ()):
            x = seeded_audio(s, 4 + frames, seed=100 + s).to(dev)
            # a non-trivial carry: 4 frames through the plain version first
            carry, _ = cell_process_plain(x[:, : 4 * HOP].contiguous(),
                                          carry_to_flat(rt.init(s)), W, st)
            xc = x[:, 4 * HOP:].contiguous()
            ref = outputs(cell_process_plain(xc, carry, W, st))
            with k2_design(design, rows):
                used = design_name(*own_k2_design(s, bf16))
                got = outputs(cell_process(xc, carry, W, st))
                # each frame alone, from the carry the plain version reaches
                each = frame_by_frame(lambda x1, c1: cell_process(x1, c1, W, st), xc, carry,
                                      W, st)
                # chunk continuity: a second call continues from the first
                # call's carry and equals one call over all frames
                cut = max(1, 3 * frames // 8) * HOP
                c1, o1 = cell_process(xc[:, :cut].contiguous(), carry, W, st)
                c2, o2 = cell_process(xc[:, cut:].contiguous(), c1, W, st)
            torch.cuda.synchronize()
            tag = f"S={s}, design {used} ({label})"
            err, rel, mean = compare_cell(tag, got, ref, tol_max, tol_mean)
            worst = max(worst, err)
            rel1, mean1 = worst_errs(each)
            if out_of_bounds(each, bounds["one frame"]):
                fail(f"K2 {tag}, each frame from the plain carry: {each} beyond "
                     f"{bounds['one frame']}")
            if bf16 and (s, design) == (64, None):
                check_bf16_bounds(label, xc, carry, W, st)
            cerr, _, _ = compare_cell(tag + " two calls",
                                      dict(c2, audio=torch.cat([o1, o2], 1)), got, 1e-5)
            means = "" if tol_mean is None else f", mean within {tol_mean:g} ({mean:.2e})"
            top1, mean_tol1 = bounds["one frame"]
            print(f"K2 S={s}, {frames} frames, design {used}"
                  f"{'' if design is None else ' (forced)'}, {label}: 12 outputs within "
                  f"{tol_max:g} x max|plain| (max abs err {err:.2e}, {rel:.2e} of the largest)"
                  f"{means}; each frame from the plain carry within {top1:g} ({rel1:.2e}), "
                  f"mean within {mean_tol1:g} ({mean1:.2e}); "
                  f"{cut // HOP} + {frames - cut // HOP} frames in two calls equal one "
                  f"call to 1e-5 (max abs err {cerr:.2e})")

    # silence skip: 8 frames of zeros count to 8 and mute the output, a loud
    # frame resets the counter
    rt = WholeCellStreamingRuntime(model, df_state, matmul_dtype=dtype)
    flat = carry_to_flat(rt.init(3))
    c, o = cell_process(torch.zeros((3, 8 * HOP), device=dev), flat, rt.weights, rt.statics)
    torch.cuda.synchronize()
    if not bool((c["sil"][:, 0] == 8).all()) or bool(o[:, 6 * HOP:].any()):
        fail(f"K2 silence skip: counter {c['sil'][:, 0].tolist()}, output not muted")
    c, _ = cell_process(torch.full((3, HOP), 0.5, device=dev), c, rt.weights, rt.statics)
    if not bool((c["sil"][:, 0] == 0).all()):
        fail("K2 silence skip: a loud frame did not reset the counter")
    print(f"K2 silence skip ({dtype_name(dtype)}): 8 zero frames count to 8 and mute from "
          "frame 6 on; a loud frame resets the counter")
    return worst, rt


def time_whole_cell_all(dev, card, rt, tag):
    """K2's times at the main path's shape and at more streams; returns the
    main path's (S=64 x 200) for the kernels line."""
    t = time_whole_cell(dev, card, rt, 64, 200)
    for s, frames in ((512, 30), (1056, 20), (4096, 20)):
        time_whole_cell(dev, card, rt, s, frames)
    return dict(name=f"cell_process{tag}", route="cuda",
                source="deepfilternet_torch/csrc/whole_cell.cu",
                replaces="deepfilternet_tpu/ops/pallas_cell.py:640", **t)


def whole_cell_work(weights, s, frames):
    """(operations, bytes) of one call. Operations: every product's 2*S*K*N
    per frame at the widths the function needs, not the padded ones the weight
    set is stored at: 481 bins where the set holds 512 (`dft`, used twice,
    `erb_fwd`, `erb_inv`), 96 lanes where it holds 128 (the 16 channel blocks
    of `c0w_t*` and `c1_w`, the 10 of `df_out_w`), and `convp_co` on each of
    the 96 DF bins. Bytes: the weights as stored (float32 or bfloat16), the
    audio in and out and the carry in and out (float32), each moved once."""
    from deepfilternet_torch.ops.whole_cell import BLK, CKEYS, FPAD, NFREQ

    nb_df = 96

    def macs(k, w):
        if k.endswith("_b") or "bih" in k or "bhh" in k or k == "imult":
            return 0  # added or multiplied elementwise, not a product
        rows, cols = w.shape
        if k == "dft":
            return 2 * rows * (cols // FPAD) * NFREQ  # analysis and synthesis
        if k == "erb_fwd":
            return NFREQ * cols
        if k == "erb_inv":
            return rows * NFREQ
        if k.startswith("c0w_t") or k == "df_out_w":
            return rows * (cols // BLK) * nb_df
        if k == "c1_w":
            return (rows // BLK) * nb_df * cols
        if k == "convp_co":
            return rows * cols * nb_df
        return rows * cols

    per_stream_frame = sum(macs(k, w) for k, w in weights.items())
    flops = 2 * s * per_stream_frame * frames
    nbytes = (sum(w.numel() * w.element_size() for w in weights.values())
              + 4 * (2 * s * frames * HOP + 2 * s * sum(d for _, d in CKEYS)))
    return flops, nbytes


def time_whole_cell(dev, card, rt, s, frames):
    """K2's time for one call of `frames` frames at S streams beside its plain
    version and the card's bound for the same work, at the runtime's operand
    type. No single PyTorch call computes this function, so it has no library
    time. The bound of bfloat16 work takes its operations at the bfloat16
    tensor-core rate, the rate of the unit its build multiplies on."""
    from deepfilternet_torch.ops.whole_cell import cell_process, cell_process_plain
    from deepfilternet_torch.streaming_whole_cell import carry_to_flat

    x = seeded_audio(s, frames, seed=7).to(dev)
    carry = carry_to_flat(rt.init(s))
    W, st = rt.weights, rt.statics
    bf16 = W["dft"].dtype == torch.bfloat16
    own = own_k2_design(s, bf16)
    # the designs the wrapper did not pick here, timed beside its choice
    designs = (("units", None), ("rows", 4), ("rows", 8)) + ((("rows", 16),) if bf16 else ())
    others = [d for d in designs if d != own]

    def forced(design, rows):
        def run():
            with k2_design(design, rows):
                return cell_process(x, carry, W, st)
        return run

    fns = {"kernel": lambda: cell_process(x, carry, W, st),
           "plain": lambda: cell_process_plain(x, carry, W, st)}
    fns.update({f"kernel forced to {design_name(*d)}": forced(*d) for d in others})
    times = {k: [] for k in fns}
    for _ in range(3):
        for k, fn in fns.items():
            times[k].append(time_ms(fn, iters=2))
    t = {k: float(np.median(v)) for k, v in times.items()}
    flops, nbytes = whole_cell_work(W, s, frames)
    peak_flops, _, peak_bf16, peak_bw = peaks(card)
    peak_type = peak_bf16 if bf16 else peak_flops
    t_ops, t_bytes = flops / peak_type * 1e3, nbytes / peak_bw * 1e3
    bound_ms = max(t_ops, t_bytes)
    rest = "".join(f", {k} {v / frames:.4f} ms" for k, v in t.items()
                   if k not in ("kernel", "plain"))
    print(f"K2 S={s} x {frames} frames in one call, {dtype_name(W['dft'].dtype)} operands, on "
          f"{card}, per frame: kernel (design {design_name(*own)}) {t['kernel'] / frames:.4f} ms, "
          f"plain {t['plain'] / frames:.4f} ms{rest}, no single library call; bound "
          f"{bound_ms / frames:.4f} ms ({flops / frames / 1e9:.3f} GFLOP at "
          f"{peak_type / 1e12:.1f} TFLOP/s {'bfloat16 tensor cores' if bf16 else 'float32'} = "
          f"{t_ops / frames:.4f} ms; {nbytes / 1e6:.2f} MB a call at {peak_bw / 1e12:.2f} TB/s = "
          f"{t_bytes:.4f} ms a call); kernel at {bound_ms / t['kernel']:.1%} of the bound; "
          f"per call: kernel {t['kernel']:.3f} ms, plain {t['plain']:.3f} ms, bound "
          f"{bound_ms:.3f} ms")
    # where a frame's time goes: every block's time by stage, from the
    # records the kernel writes while a profiler records
    rec = k2_traced_record(lambda: cell_process(x, carry, W, st), f"S={s} x {frames}")
    print_k2_split(rec, f"K2 S={s} x {frames} frames, {dtype_name(W['dft'].dtype)}, design "
                   f"{design_name(*own)}")
    if own[0] == "units":
        rates = units_read_rates(s, bf16, rec["ns"][0, :-1] / frames)
        print(f"K2 S={s} units, block 0's reads from L2 a frame by phase (input tiles and "
              "weight slices of its units, from the plan) over its time in the phase: "
              + "; ".join(f"{name} {kb:.1f} KB {r:.1f} GB/s" for name, kb, r in rates))
        if s in REPEAT_S:
            repeat_calls(tag=f"S={s} x {frames}, {dtype_name(W['dft'].dtype)}",
                         fn=lambda: cell_process(x, carry, W, st))
    return dict(ms=t["kernel"], plain_ms=t["plain"], bound_ms=bound_ms,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                library_ms=None, frames_per_launch=frames, design=design_name(*own))


# the units design's repeated calls: a race between a unit and the counters
# it waits on would show as a difference between calls
REPEAT_S, REPEAT_CALLS = (64, 512), 20


def repeat_calls(tag, fn):
    """REPEAT_CALLS calls of `fn` on the same inputs: every output of every
    call bit for bit the first's."""
    first = None
    for i in range(REPEAT_CALLS):
        c, o = fn()
        got = dict(c, audio=o)
        if first is None:
            first = {k: v.clone() for k, v in got.items()}
            continue
        differ = [k for k in first if not torch.equal(first[k], got[k])]
        if differ:
            fail(f"K2 units {tag}: call {i + 1} of {REPEAT_CALLS} differs from the first in "
                 f"{differ}")
    torch.cuda.synchronize()
    print(f"K2 units {tag}: {REPEAT_CALLS} calls on the same inputs, the 12 outputs of each "
          "bit for bit the first's")


def k2_traced_record(fn, tag):
    """Run `fn` (one K2 call) while a profiler records and return the call's
    record (`utils.timings.k2_records`); fails unless there is exactly one
    and every block's stages add up to within 2% of its own span."""
    from torch.profiler import ProfilerActivity, profile

    from deepfilternet_torch.ops import whole_cell as wc
    from deepfilternet_torch.utils import timings

    timings.k2_clear()
    every, wc.RECORD_EVERY = wc.RECORD_EVERY, 1  # this traced call records, whatever came before
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            fn()
    finally:
        wc.RECORD_EVERY = every
    torch.cuda.synchronize()
    recs = timings.k2_records()
    if len(recs) != 1:
        fail(f"K2 {tag}: {len(recs)} records for one traced call")
    rec = recs[0]
    total = rec["ns"].sum(axis=1).astype(np.float64)
    own = (rec["span"][:, 1] - rec["span"][:, 0]).astype(np.float64)
    if rec["ns"].shape[1] != len(rec["stages"]) or not (own > 0).all() or (
            np.abs(total - own) > 0.02 * own).any():
        fail(f"K2 {tag}: records malformed (stage sums {total[:4]}..., spans {own[:4]}...)")
    return rec


def print_k2_split(rec, tag):
    """The stage split of one K2 record: the median and the slowest block a
    frame by stage, the families averaged over blocks, the blocks' busy share
    and, in the units design, each block's wait on producers."""
    from deepfilternet_torch.utils import timings

    sp, frames = timings.k2_split(rec), rec["frames"]
    us = 1e3 / frames
    print(f"{tag}: {len(rec['ns'])} blocks, {sp['call_ms'] * us:.1f} us a frame from the first "
          f"block's start to the last one's end, blocks busy {sp['busy']:.2%} of it; families "
          "(mean over blocks, us a frame) "
          + ", ".join(f"{k} {v * us:.1f}" for k, v in sp["family_ms"].items())
          + "; by stage (median block / slowest block, us a frame): "
          + "; ".join(f"{n} {a * us:.1f}/{b * us:.1f}" for n, a, b in
                      zip(rec["stages"], sp["stage_median_ms"], sp["stage_max_ms"])))
    if rec["design"] == "units":
        print(f"{tag}: each block's wait on producers (us a frame, block order): "
              + " ".join(f"{v / frames / 1e3:.1f}" for v in rec["ns"][:, -1]))


def units_read_rates(s, bf16, ns):
    """(phase, KB, GB/s) that block 0 of the units design reads from L2 in
    each phase of a frame: for each of its units (the plan deals unit u of a
    phase to the block whose rank there is u mod the block count) the input
    tile's K rows of 64 streams in float32 and its weight slice as packed,
    over block 0's ns in that phase."""
    from deepfilternet_torch.ops import whole_cell_plan as wp

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    table, _ = wp.cached_plan(s, n_sm, bf16)
    t = wp.decode(table)
    n_pre = int(t.header[wp.H_PRE])
    out = []
    for i, name in enumerate(wp.STAGES[:-1]):
        first, count, _ = (int(v) for v in t.phases[n_pre + i])
        nbytes = 0
        for j in t.jobs[first: first + count]:
            if j[wp.J_TYPE] != wp.T_GEMM:
                continue
            cols = wp.packed_cols(int(j[wp.J_NCAT] * j[wp.J_CW]), bf16)
            per_unit = int(j[wp.J_K]) * (wp.RT * 4 + cols * (2 if bf16 else 4))
            begin, units = int(j[wp.J_BEGIN]), int(j[wp.J_UNITS])
            nbytes += per_unit * sum(1 for u in range(begin, begin + units)
                                     if u % n_sm == t.ranks[i][0])
        out.append((name, nbytes / 1e3, nbytes / max(float(ns[i]), 1.0)))
    return out


# -- phase 4: the main path --------------------------------------------------


def profile_frames(rt, audio, card, label="main path"):
    """Where a frame's time goes: device busy share and the largest device
    ops, from torch.profiler over a short run (the profiler's own host cost
    inflates the wall time, so the busy share is a lower bound)."""
    from torch.profiler import ProfilerActivity, profile

    s, n = audio.shape[0], audio.shape[1] // rt.stft_cfg.hop_size
    carry = rt.init(s)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S[0])  # see kernel_device_ms
        t0 = time.perf_counter()
        rt.process(carry, audio)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        time.sleep(PROFILE_PAD_S[0])
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        print(f"{label} profile: the profiler recorded no device time (not measured)")
        return
    busy_us = sum(e.self_device_time_total for e in dev)
    ops = sum(e.count for e in dev)
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    print(f"{'bfloat16 ' if getattr(rt, 'dtype', None) == torch.bfloat16 else ''}{label} "
          f"profile, S={s}, {n} frames, profiler on, {card}: wall "
          f"{wall_us / n:.1f} us/frame, device busy {busy_us / n:.1f} us/frame "
          f"({busy_us / wall_us:.1%}), {ops / n:.1f} device ops/frame; largest: "
          + "; ".join(f"{e.key[:48]} x{e.count // n} {e.self_device_time_total / n:.1f} us"
                      for e in top))


def max_abs_err(got, ref):
    return float(np.abs(got - ref).max())


def main_path(card, model, df_state, cpu_model, cpu_state, audio, tag, dtype=torch.float32,
              cpu_rows=4, cpu_frames=None, tol=1e-4, err_fn=max_abs_err, scan_rows=0,
              profile=False):
    """The per-frame path of one model: StreamingRuntime.process over `audio`
    from a fresh carry after a 5-frame warm-up, K1 once a frame (hop from
    df_state); its first `cpu_rows` streams (over `cpu_frames` frames, or
    all) against the same run on the CPU, `err_fn` within `tol` (skipped
    without a CPU model); with `scan_rows`, enhance(backend="scan") on that
    many rows of 2 s against the CPU on 2 rows at 1e-4. Returns {launches,
    out (on the host, float32), wall (seconds), err, scan_launches}."""
    from deepfilternet_torch.enhance import enhance
    from deepfilternet_torch.ops.fused_frontend import fused_analysis_frontend as k1
    from deepfilternet_torch.streaming import StreamingRuntime

    rt = StreamingRuntime(model, df_state, dtype=dtype)
    s, hop = audio.shape[0], df_state.hop_size
    n_frames, seconds = audio.shape[1] // hop, audio.shape[1] / SR
    rt.process(rt.init(s), audio[:, : 5 * hop])  # warm-up (library handles, caches)
    torch.cuda.synchronize()

    k1.launches = 0
    t0 = time.perf_counter()
    _, out = rt.process(rt.init(s), audio)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = k1.launches
    if launches != n_frames:
        fail(f"{tag}: K1 launches {launches} != frames processed {n_frames}")
    out = out.float().cpu().numpy()
    if out.shape != audio.shape or not np.isfinite(out).all():
        fail(f"{tag}: output {out.shape} not finite / not {audio.shape}")
    kind = "" if dtype == torch.float32 else f"(dtype={dtype_name(dtype)})"
    print(f"{tag}: StreamingRuntime{kind}.process S={s} x {seconds} s = {n_frames} frames, K1 "
          f"launches {launches}; {wall:.3f} s wall, aggregate RTF {seconds * s / wall:.1f}x on "
          f"{card} (information only)")
    if profile:
        profile_frames(rt, audio[:, : 20 * hop], card)

    err = None
    if cpu_model is not None:
        cpu_rt = StreamingRuntime(cpu_model, cpu_state, dtype=dtype)
        n = audio.shape[1] if cpu_frames is None else cpu_frames * hop
        ref = cpu_rt.process(cpu_rt.init(cpu_rows), audio[:cpu_rows, :n])[1].float().numpy()
        err = err_fn(out[:cpu_rows, :n], ref)
        what = "max abs err" if err_fn is max_abs_err else "of the largest value"
        if not err <= tol:
            fail(f"{tag}: {cpu_rows} streams differ from the CPU run by {err:.3e} ({what}) > "
                 f"{tol}")
        print(f"{tag} vs the same {cpu_rows} streams"
              + ("" if cpu_frames is None else f" x {cpu_frames} frames")
              + f" on the CPU: {what} {err:.3e} (tol {tol}); output rms "
              f"{float(np.sqrt(np.mean(out ** 2))):.4f}, input rms "
              f"{float(np.sqrt(np.mean(audio ** 2))):.4f}")

    scan = None
    if scan_rows:
        batch = noisy_speech_like(scan_rows, SECONDS, seed=1)
        k1.launches = 0
        t0 = time.perf_counter()
        enh = enhance(model, df_state, batch, backend="scan")
        wall_scan = time.perf_counter() - t0
        scan = k1.launches
        n_enh = (batch.shape[1] + df_state.fft_size) // hop
        if scan != n_enh:
            fail(f"{tag} enhance: K1 launches {scan} != frames {n_enh}")
        if enh.shape != batch.shape or not np.isfinite(enh).all():
            fail(f"{tag} enhance(backend='scan') output malformed")
        e = max_abs_err(enh[:2], enhance(cpu_model, cpu_state, batch[:2], backend="scan"))
        if not e <= 1e-4:
            fail(f"{tag} enhance: 2 rows differ from the CPU run by {e:.3e} > 1e-4")
        print(f"{tag} enhance(backend='scan') [{scan_rows}, {SECONDS} s]: {n_enh} frames, K1 "
              f"launches {scan}, {wall_scan:.3f} s wall; vs CPU on 2 rows max abs err {e:.3e} "
              "(tol 1e-4)")
    return dict(launches=launches, out=out, wall=wall, err=err, scan_launches=scan)


def scale_err(got, ref):
    """Largest absolute difference over the reference's largest value."""
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()), 1e-30)


# Two bfloat16 runtimes drift apart as frames go by: the per-frame runtime
# keeps its GRU states in bfloat16 (as the JAX package's does), and a rounding
# flip in one carries on. Over these 200 frames the JAX package's own pairs
# read 7.5e-2 (per-frame bfloat16 against float32) and 8.4e-2 (whole cell
# against per-frame, both bfloat16) of the largest value, on the CPU
# (`python tests/test_torch_reduced_precision.py`); the comparisons with the
# per-frame bfloat16 runtime use the JAX tests' bound for such pairs.
BF16_DRIFT_TOL = 0.1


def whole_cell_path(card, model, df_state, cpu_model, cpu_state, audio, per_frame_out,
                    per_frame_wall, dtype=torch.float32, f32_out=None):
    """The whole-cell path at `dtype` operands: the same 64 x 2 s through
    WholeCellStreamingRuntime.process, one kernel launch for all frames.
    Returns the kernel's launches in that call and its output (numpy).

    float32: held against the per-frame runtime on the card at the JAX
    tests' atol 2e-4 + rtol 1e-3, and the plain version on the CPU at 1e-4.
    bfloat16 (the runtime's default): against the per-frame bfloat16 runtime
    on the card at BF16_DRIFT_TOL of its largest value (the JAX tests' bound
    for two bfloat16 runtimes that round differently inside the model: the
    per-frame one keeps its GRU states in bfloat16, the whole cell in
    float32), against
    the float32 whole-cell output `f32_out` and the plain version on the CPU
    at 0.05 (the JAX tests' bound for bfloat16 against float32 and for two
    bfloat16 runs that sum in another order). Both: two calls equal one to
    1e-5, then one frame a call."""
    from deepfilternet_torch.ops.whole_cell import cell_process as k2
    from deepfilternet_torch.streaming_whole_cell import WholeCellStreamingRuntime

    bf16 = dtype == torch.bfloat16
    kw = {} if bf16 else dict(matmul_dtype=torch.float32)  # bfloat16: the default
    rt = WholeCellStreamingRuntime(model, df_state, **kw)
    if rt.matmul_dtype != dtype:
        fail(f"WholeCellStreamingRuntime runs {rt.matmul_dtype}, not {dtype}")
    s, n_frames = audio.shape[0], audio.shape[1] // HOP
    rt.process(rt.init(s), audio[:, : 5 * HOP])  # warm-up
    torch.cuda.synchronize()

    k2.launches = k2.bf16_launches = k2.frames = 0
    t0 = time.perf_counter()
    carry, out_dev = rt.process(rt.init(s), audio)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, frames, bf16_launches = k2.launches, k2.frames, k2.bf16_launches
    if launches != 1 or frames != n_frames or bf16_launches != int(bf16):
        fail(f"K2 launches {launches} (want 1), frames {frames} (want {n_frames}), of them "
             f"bfloat16 {bf16_launches} (want {int(bf16)})")
    out = out_dev.cpu().numpy()
    if out.shape != audio.shape or not np.isfinite(out).all():
        fail(f"whole-cell output {out.shape} not finite / not {audio.shape}")
    print(f"whole-cell path ({MODEL_DIR}, {dtype_name(dtype)} operands): "
          f"WholeCellStreamingRuntime.process S={s} x {SECONDS} s = {n_frames} frames, K2 "
          f"launches {launches} ({bf16_launches} of the bfloat16 build), frames in them {frames}; "
          f"{wall:.3f} s wall, aggregate RTF {SECONDS * s / wall:.1f}x beside the per-frame "
          f"path's {per_frame_wall:.3f} s, {SECONDS * s / per_frame_wall:.1f}x, on {card} "
          "(information only)")

    cpu_rt = WholeCellStreamingRuntime(cpu_model, cpu_state, backend="plain", **kw)
    _, ref = cpu_rt.process(cpu_rt.init(4), audio[:4])
    if bf16:
        checks = [("the per-frame bfloat16 runtime on the card", scale_err(out, per_frame_out),
                   BF16_DRIFT_TOL),
                  ("the float32 whole-cell runtime on the card", scale_err(out, f32_out), 0.05),
                  ("backend='plain' on the CPU, 4 streams", scale_err(out[:4], ref.numpy()),
                   0.05)]
        for name, e, tol in checks:
            if not e <= tol:
                fail(f"whole-cell bfloat16 vs {name}: {e:.3e} of its largest value > {tol}")
        summary = "; ".join(f"vs {name}: {e:.3e} of its largest value (tol {tol})"
                            for name, e, tol in checks)
    else:
        # against the per-frame runtime on the card, at the tolerance the JAX
        # tests hold this pair to
        err = float(np.abs(out - per_frame_out).max())
        excess = np.abs(out - per_frame_out) - (2e-4 + 1e-3 * np.abs(per_frame_out))
        if not excess.max() <= 0:
            fail(f"whole-cell vs per-frame runtime: max abs err {err:.3e} beyond atol 2e-4 + "
                 "rtol 1e-3")
        err_cpu = float(np.abs(out[:4] - ref.numpy()).max())
        if not err_cpu <= 1e-4:
            fail(f"whole-cell: 4 streams differ from the plain CPU run by {err_cpu:.3e} > 1e-4")
        summary = (f"vs the per-frame runtime on the card: max abs err {err:.3e} (atol 2e-4, "
                   f"rtol 1e-3); vs backend='plain' on the CPU, 4 streams: {err_cpu:.3e} "
                   "(tol 1e-4)")
    half = (n_frames // 2) * HOP
    c, o1 = rt.process(rt.init(s), audio[:, :half])
    c, o2 = rt.process(c, audio[:, half:])
    err_two = float((torch.cat([o1, o2], dim=1) - out_dev).abs().max())
    if not err_two <= 1e-5:
        fail(f"whole-cell: two calls differ from one by {err_two:.3e} > 1e-5")
    if int((c.silence_ctr != carry.silence_ctr).sum()) or c.silence_ctr.dtype != torch.int32:
        fail("whole-cell: silence counters differ between one call and two")
    # per-hop latency: the same runtime called one frame at a time, each call
    # waited for (host clock around process + synchronize)
    c = rt.init(s)
    hops = []
    for f in range(110):
        frame = audio[:, f * HOP: (f + 1) * HOP]
        t0 = time.perf_counter()
        c, _ = rt.process(c, frame)
        torch.cuda.synchronize()
        hops.append((time.perf_counter() - t0) * 1e3)
    hops = np.asarray(hops[10:])  # the first calls warm the allocator's cache
    print(f"whole-cell runtime ({dtype_name(dtype)}) one frame a call, S={s}, 100 calls on "
          f"{card}: median {np.median(hops):.3f} ms, worst {hops.max():.3f} ms a hop of 10 ms "
          "(host clock, audio already on the host as numpy; information only)")
    print(f"whole-cell ({dtype_name(dtype)}) {summary}; two calls of {n_frames // 2} frames vs "
          f"one: {err_two:.3e} (tol 1e-5)")
    return launches, out


# -- phase 5: the offline forward, the chunked runtime and the CLI -------------

OFFLINE_ROWS, OFFLINE_SECONDS = 16, 10.0


def profile_call(fn, label, card, audio_seconds):
    """Device busy share and the largest device ops of one call, from
    torch.profiler (its own host cost inflates the wall time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S[0])  # see kernel_device_ms
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(PROFILE_PAD_S[0])
    # a user annotation (the optimizer's step) spans its kernels on the
    # device too: counted, it would count their time twice
    spans = {e.name for e in prof.events() if getattr(e, "is_user_annotation", False)}
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in spans]
    if not dev:
        print(f"{label} profile: the profiler recorded no device time (not measured)")
        return
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    print(f"{label} profile, profiler on, {card}: wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms ({busy_ms / wall_ms:.1%}), {sum(e.count for e in dev)} device ops "
          f"for {audio_seconds:.0f} s of audio; largest: "
          + "; ".join(f"{e.key[:48]} x{e.count} {e.self_device_time_total / 1e3:.2f} ms"
                      for e in top))


def offline_and_chunked_path(card, model, df_state, cpu_model, cpu_state, audio,
                             per_frame_out):
    """enhance() with its default backend, ChunkedStreamingRuntime and the
    CLI. None of them launches K1 or K2: both counts are set to 0 before the
    paths run and must read 0 after."""
    from deepfilternet_torch.enhance import enhance, main as cli
    from deepfilternet_torch.ops.fused_frontend import fused_analysis_frontend as k1
    from deepfilternet_torch.ops.whole_cell import cell_process as k2
    from deepfilternet_torch.streaming import ChunkedStreamingRuntime
    from deepfilternet_torch.utils import load_audio, save_audio

    batch = noisy_speech_like(OFFLINE_ROWS, OFFLINE_SECONDS, seed=2)
    # references first: the per-frame runtime on the card (it launches K1)
    # over the first 2 s of 2 rows, and the offline path on the CPU
    short = batch[:2, : int(SECONDS * SR)]
    scan = enhance(model, df_state, short, backend="scan")
    cpu_ref = enhance(cpu_model, cpu_state, batch[:2])

    k1.launches = k2.launches = 0
    t0 = time.perf_counter()
    enh = enhance(model, df_state, batch)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    enh = enhance(model, df_state, batch)
    wall = time.perf_counter() - t0
    if enh.shape != batch.shape or not np.isfinite(enh).all():
        fail(f"enhance() default backend: output {enh.shape} not finite / not {batch.shape}")
    err_cpu = float(np.abs(enh[:2] - cpu_ref).max())
    if not err_cpu <= 1e-4:
        fail(f"enhance() default backend: 2 rows differ from the CPU run by {err_cpu:.3e} > 1e-4")
    # the first 2 s fix every output sample up to 2 s - delay in the longer run
    n = short.shape[1] - df_state.delay
    err_scan = float(np.abs(enh[:2, :n] - scan[:, :n]).max())
    if not err_scan <= 1e-4:
        fail(f"enhance() default backend vs backend='scan' on the card: {err_scan:.3e} > 1e-4")
    rows_s = OFFLINE_ROWS * OFFLINE_SECONDS
    print(f"enhance() default backend (offline) [{OFFLINE_ROWS}, {OFFLINE_SECONDS} s] on {card}: "
          f"{wall:.3f} s wall, aggregate RTF {rows_s / wall:.1f}x (first call {first:.3f} s); "
          f"vs the CPU on 2 rows max abs err {err_cpu:.3e} (tol 1e-4); vs backend='scan' on the "
          f"card, first {n} samples of 2 rows: {err_scan:.3e} (tol 1e-4) (information only)")
    profile_call(lambda: enhance(model, df_state, batch), "enhance() offline", card, rows_s)

    s, n_frames = audio.shape[0], audio.shape[1] // HOP
    crt = ChunkedStreamingRuntime(model, df_state)
    crt.process(crt.init(s), audio[:, : 20 * HOP])  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry, out_dev = crt.process(crt.init(s), audio)
    torch.cuda.synchronize()
    c_wall = time.perf_counter() - t0
    out = out_dev.cpu().numpy()
    if out.shape != audio.shape or not np.isfinite(out).all():
        fail(f"chunked runtime output {out.shape} not finite / not {audio.shape}")
    err_pf = float(np.abs(out - per_frame_out).max())
    if not err_pf <= 1e-4:
        fail(f"chunked runtime vs per-frame runtime on the card: {err_pf:.3e} > 1e-4")
    cut = 73 * HOP  # 3 chunks of 20 and one of 13, then 6 of 20 and one of 7
    c, o1 = crt.process(crt.init(s), audio[:, :cut])
    c, o2 = crt.process(c, audio[:, cut:])
    err_two = float((torch.cat([o1, o2], dim=1) - out_dev).abs().max())
    if not err_two <= 1e-5:
        fail(f"chunked runtime: two calls differ from one by {err_two:.3e} > 1e-5")
    if int((c.silence_ctr != carry.silence_ctr).sum()) or c.silence_ctr.dtype != torch.int32:
        fail("chunked runtime: silence counters differ between one call and two")
    print(f"chunked runtime S={s} x {SECONDS} s = {n_frames} frames in chunks of "
          f"{crt.chunk_frames} on {card}: {c_wall:.3f} s wall, aggregate RTF "
          f"{SECONDS * s / c_wall:.1f}x (information only); vs the per-frame runtime on the "
          f"card max abs err {err_pf:.3e} (tol 1e-4); 73 + {n_frames - 73} frames in two calls "
          f"vs one {err_two:.3e} (tol 1e-5)")
    profile_call(lambda: crt.process(crt.init(s), audio), "chunked runtime", card, SECONDS * s)

    with tempfile.TemporaryDirectory() as tmp:
        wav = os.path.join(tmp, "noisy.wav")
        save_audio(wav, batch[:1], SR)
        t0 = time.perf_counter()
        cli([wav, "-o", tmp])
        cli_wall = time.perf_counter() - t0
        got, sr = load_audio(os.path.join(tmp, "noisy_DeepFilterNet_TPU.wav"))
        # what the CLI computes: the int16 input through enhance(), written as int16
        want = enhance(model, df_state, load_audio(wav)[0])
    want = np.round(np.clip(want, -1.0, 1.0) * 32767.0) / 32768.0
    err_cli = float(np.abs(got - want).max()) * 32768
    if sr != SR or got.shape != (1, batch.shape[1]) or not err_cli <= 1.0:
        fail(f"CLI output {got.shape} at {sr} Hz, {err_cli:.2f} int16 steps from enhance()")
    print(f"CLI on one {OFFLINE_SECONDS} s wav on {card}: {cli_wall:.3f} s wall with model "
          f"loading; {err_cli:.0f} int16 steps from enhance() at most (tol 1)")

    if k1.launches or k2.launches:
        fail(f"offline / chunked / CLI paths launched K1 {k1.launches}, K2 {k2.launches} times")
    print("offline, chunked and CLI paths: K1 launches 0, K2 launches 0 (neither is on them)")


# -- phase 6: reduced precision -----------------------------------------------


def reduced_precision_path(dev, card, model, df_state, cpu_model, cpu_state, audio,
                           per_frame_out, wc_f32_out):
    """K2's bfloat16 build against its plain version and timed; then the
    bfloat16 runtimes on the main path's 64 x 2 s. Returns K2 bfloat16's
    entry of the kernels line."""
    from deepfilternet_torch.ops.fused_frontend import fused_analysis_frontend as k1
    from deepfilternet_torch.ops.whole_cell import cell_process as k2
    from deepfilternet_torch.streaming import ChunkedStreamingRuntime, StreamingRuntime

    bf16 = torch.bfloat16
    worst, rt_b = check_whole_cell(dev, card, model, df_state, bf16)
    k2b = time_whole_cell_all(dev, card, rt_b, " (bfloat16)")

    # the per-frame runtime at bfloat16: K1 (float32) once a frame, the model
    # in bfloat16
    s, n_frames = audio.shape[0], audio.shape[1] // HOP
    rt = StreamingRuntime(model, df_state, dtype=bf16)
    rt.process(rt.init(s), audio[:, : 5 * HOP])  # warm-up
    torch.cuda.synchronize()
    k1.launches = k2.launches = k2.bf16_launches = 0
    t0 = time.perf_counter()
    carry, out_dev = rt.process(rt.init(s), audio)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1_launches = k1.launches
    if k1_launches != n_frames or k2.launches:
        fail(f"bfloat16 per-frame path: K1 launches {k1_launches} (want {n_frames}), K2 "
             f"{k2.launches} (want 0)")
    out = out_dev.cpu().numpy()
    if out.shape != audio.shape or out_dev.dtype != torch.float32 or not np.isfinite(out).all():
        fail(f"bfloat16 per-frame output {out.shape} {out_dev.dtype} malformed")
    kinds = {f: str(getattr(carry.model, f).dtype) for f in carry.model._fields}
    if any((t != "torch.float32") if "ring" in f else (t != "torch.bfloat16")
           for f, t in kinds.items()):
        fail(f"bfloat16 per-frame carry types {kinds}")
    profile_frames(rt, audio[:, : 20 * HOP], card)
    cpu_rt = StreamingRuntime(cpu_model, cpu_state, dtype=bf16)
    _, ref = cpu_rt.process(cpu_rt.init(4), audio[:4])
    # 0.05: the JAX tests' bound for two bfloat16 runs that sum in another
    # order; BF16_DRIFT_TOL: their bound for a bfloat16 runtime against float32
    e_cpu, e_f32 = scale_err(out[:4], ref.numpy()), scale_err(out, per_frame_out)
    if not (e_cpu <= 0.05 and e_f32 <= BF16_DRIFT_TOL):
        fail(f"bfloat16 per-frame path: vs CPU {e_cpu:.3e} (tol 0.05), vs float32 {e_f32:.3e} "
             f"(tol {BF16_DRIFT_TOL}) of the largest value")
    print(f"bfloat16 per-frame path: StreamingRuntime(dtype=bfloat16).process S={s} x "
          f"{SECONDS} s = {n_frames} frames, K1 launches {k1_launches}; {wall:.3f} s wall, "
          f"aggregate RTF {SECONDS * s / wall:.1f}x on {card} (information only); vs the same 4 "
          f"streams on the CPU {e_cpu:.3e} of the largest value (tol 0.05), vs the float32 run "
          f"{e_f32:.3e} (tol {BF16_DRIFT_TOL})")

    crt = ChunkedStreamingRuntime(model, df_state, dtype=bf16)
    crt.process(crt.init(s), audio[:, : 20 * HOP])  # warm-up
    torch.cuda.synchronize()
    k1.launches = k2.launches = 0
    t0 = time.perf_counter()
    _, c_dev = crt.process(crt.init(s), audio)
    torch.cuda.synchronize()
    c_wall = time.perf_counter() - t0
    if k1.launches or k2.launches:
        fail(f"bfloat16 chunked path launched K1 {k1.launches}, K2 {k2.launches} times")
    c_out = c_dev.cpu().numpy()
    e_pf, e_f32 = scale_err(c_out, out), scale_err(c_out, per_frame_out)
    if not (np.isfinite(c_out).all() and e_pf <= BF16_DRIFT_TOL and e_f32 <= BF16_DRIFT_TOL):
        fail(f"bfloat16 chunked path: vs per-frame bfloat16 {e_pf:.3e}, vs float32 {e_f32:.3e} "
             f"(tol {BF16_DRIFT_TOL})")
    print(f"bfloat16 chunked runtime S={s} x {SECONDS} s in chunks of {crt.chunk_frames}: "
          f"{c_wall:.3f} s wall, aggregate RTF {SECONDS * s / c_wall:.1f}x (information only); "
          f"vs the per-frame bfloat16 run {e_pf:.3e}, vs the float32 run {e_f32:.3e} of the "
          f"largest value (tol {BF16_DRIFT_TOL}, the JAX tests' own); K1 and K2 launches 0")

    # out_dtype only casts the output: the float32 runtime's first 20 frames
    short = audio[:, : 20 * HOP]
    o_rt, f_rt = StreamingRuntime(model, df_state, out_dtype=bf16), StreamingRuntime(model, df_state)
    _, o_b = o_rt.process(o_rt.init(s), short)
    _, o_f = f_rt.process(f_rt.init(s), short)
    if o_b.dtype != bf16 or not torch.equal(o_b, o_f.to(bf16)):
        fail("out_dtype=bfloat16 is not the float32 output cast")
    print("StreamingRuntime(out_dtype=bfloat16): bfloat16 output, equal to the float32 "
          "output cast, 20 frames")

    k2b["launches"], _ = whole_cell_path(card, model, df_state, cpu_model, cpu_state, audio,
                                         out, wall, bf16, wc_f32_out)
    k2b["max_abs_err"] = worst
    return k2b


# -- phase 7: serving ---------------------------------------------------------

SERVE_SLOTS = 64
SERVE_HOPS = int(SECONDS * SR) // HOP  # each client streams 2 s, one hop a request


CLIENT_PROCS = 4  # the clients run in processes of their own, apart from the server's


def _client_group(port, audio, first, start_at, hop=HOP):
    """In a client process: one StreamClient thread a row of `audio`, each
    connected, then streaming its row from wall-clock time `start_at` on, one
    hop of `hop` samples a request, each reply waited for. Returns (first
    row, outputs, round-trip ms, errors)."""
    import threading

    from deepfilternet_torch.serve import StreamClient

    n, hops = audio.shape[0], audio.shape[1] // hop
    outs, rtt, errors = [None] * n, np.zeros((n, hops)), []

    def run(i):
        try:
            c = StreamClient(port=port, timeout=120)
            try:
                time.sleep(max(0.0, start_at - time.time()))
                got = []
                for k in range(hops):
                    t0 = time.perf_counter()
                    got.append(c.process_frame(audio[i, k * hop: (k + 1) * hop]))
                    rtt[i, k] = (time.perf_counter() - t0) * 1e3
                outs[i] = np.concatenate(got)
            finally:
                c.close()
        except Exception as e:  # noqa: BLE001 - reported to the parent
            errors.append(f"client {first + i}: {e!r}")

    threads = [threading.Thread(target=run, args=(i,), daemon=True) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    if any(t.is_alive() for t in threads):
        errors.append("clients still running after 300 s")
    return first, None if errors else np.stack(outs), rtt, errors


def _client_process_ready(_):
    """Warms a client process: imports what its clients need."""
    import deepfilternet_torch.serve  # noqa: F401

    time.sleep(0.2)  # long enough that every process of the pool takes a task


def serve_clients(pool, port, audio, hop=HOP):
    """Each row of `audio` [n, T] streamed by its own StreamClient thread,
    one hop of `hop` samples a request, each reply waited for, all starting together; the
    threads run in the CLIENT_PROCS processes of `pool`, apart from the
    server's, so the server's threads share no interpreter lock with them.
    Returns (outputs [n, T], round-trip ms of every request [n, hops], wall
    seconds from the common start to the last client's end)."""
    groups = np.array_split(np.arange(audio.shape[0]), CLIENT_PROCS)
    start_at = time.time() + 2.0  # every client connected by then
    got = pool.starmap(_client_group,
                       [(port, audio[g], int(g[0]), start_at, hop) for g in groups])
    wall = time.time() - start_at
    errors = [e for _, _, _, errs in got for e in errs]
    if errors:
        fail(f"serving {audio.shape[0]} clients: {errors}")
    return (np.concatenate([o for _, o, _, _ in got]), np.concatenate([r for _, _, r, _ in got]),
            wall)


def ws_round_trip(port, hop_audio):
    """The demo page over HTTP, then one binary hop through a WebSocket;
    returns (page bytes, the enhanced hop)."""
    import base64
    import socket
    import struct

    from deepfilternet_torch.serve_ws import read_ws_frame

    with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
        s.sendall(b"GET / HTTP/1.1\r\nHost: x\r\n\r\n")
        page = b""
        while chunk := s.recv(65536):
            page += chunk
    with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
        key = base64.b64encode(os.urandom(16)).decode()
        s.sendall((f"GET / HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\nConnection: Upgrade\r\n"
                   f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n\r\n").encode())
        head = b""
        while b"\r\n\r\n" not in head:
            head += s.recv(4096)
        if b" 101 " not in head.split(b"\r\n")[0]:
            fail(f"WebSocket handshake refused: {head[:80]!r}")
        payload = hop_audio.astype("<f4").tobytes()
        mask = os.urandom(4)
        masked = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
        s.sendall(bytes([0x82, 0x80 | 126]) + struct.pack(">H", len(payload)) + mask + masked)
        frame = read_ws_frame(s)
        s.sendall(bytes([0x88, 0x80]) + mask)  # close
    if frame is None or frame[0] != 0x2:
        fail(f"WebSocket reply {frame and frame[0]}: not a binary frame")
    return page, np.frombuffer(frame[1], "<f4")


def serving_path(card, smi, model, df_state, audio, per_frame_out):
    """Phase 7: StreamServer on the card (each tick one replay of a CUDA
    graph that holds K1), driven by 16 and then 64 concurrent clients over
    localhost, each client's output held against StreamingRuntime.process of
    the same audio on the card (`per_frame_out`, phase 4) at 1e-5; the tick's
    device and host times and the per-hop latency; the server over a
    one-device mesh (the same output bit for bit) and over two shards of the
    one card (within 1e-5), each with one replay a shard and tick; the
    WebSocket bridge once.
    Returns the graph replays of the client runs (each launches K1 once)."""
    import multiprocessing as mp

    with mp.get_context("spawn").Pool(CLIENT_PROCS) as pool:
        pool.map(_client_process_ready, range(4 * CLIENT_PROCS), chunksize=1)
        return _serving_path(pool, smi, model, df_state, audio[:, : SERVE_HOPS * HOP],
                             per_frame_out[:, : SERVE_HOPS * HOP])


def _serving_path(pool, smi, model, df_state, audio, ref):
    from deepfilternet_torch.ops.fused_frontend import fused_analysis_frontend as k1
    from deepfilternet_torch.ops.whole_cell import cell_process as k2
    from deepfilternet_torch.parallel import Mesh, data_parallel_mesh
    from deepfilternet_torch.serve import StreamServer
    from deepfilternet_torch.serve_ws import WsBridge

    k1.launches = k2.launches = 0
    # a 16-slot server only for its tick's device time, built (and captured)
    # before any server thread runs
    small = StreamServer(model, df_state, port=0, max_streams=16)
    t0 = time.perf_counter()
    srv = StreamServer(model, df_state, port=0, max_streams=SERVE_SLOTS).start()
    build_s = time.perf_counter() - t0
    replays, outs16 = 0, None
    try:
        if srv.graph_captures != 1 or srv.k1_in_graph != [1]:
            fail(f"server: {srv.graph_captures} graphs captured (want 1), K1 launches in the "
                 f"graph {srv.k1_in_graph} (want [1])")
        print(f"server ({MODEL_DIR}, float32, {SERVE_SLOTS} slots): built and captured in "
              f"{build_s:.2f} s; graphs captured {srv.graph_captures}, K1 launches recorded in "
              f"the graph {srv.k1_in_graph} (K1's counter over both servers' warm-up ticks "
              f"and captures: {k1.launches})")
        for n in (16, 64):
            d0, f0, r0 = srv.dispatches, srv.frames_processed, srv.graph_replays
            srv.tick_host_times.clear()
            srv.dispatch_times.clear()
            got, rtt, wall = serve_clients(pool, srv.port, audio[:n])
            d, f, r = srv.dispatches - d0, srv.frames_processed - f0, srv.graph_replays - r0
            err = float(np.abs(got - ref[:n]).max())
            if not err <= 1e-5:
                fail(f"server, {n} clients: max abs err {err:.3e} against "
                     "StreamingRuntime.process on the card > 1e-5")
            if not (r == d * srv.graph_captures and 0 < d < f and f == n * SERVE_HOPS):
                fail(f"server, {n} clients: replays {r}, dispatches {d}, frames {f} (want "
                     f"replays == dispatches < frames == {n * SERVE_HOPS})")
            replays += r
            if n == 16:
                outs16 = got
            host = np.asarray(srv.tick_host_times) * 1e3
            fetch = np.asarray(srv.dispatch_times) * 1e3
            p50, p99, worst = np.percentile(rtt, 50), np.percentile(rtt, 99), rtt.max()
            print(f"server, {n} concurrent clients x {SERVE_HOPS} hops, one hop a request, on "
                  f"{smi}: max abs err {err:.2e} against StreamingRuntime.process on the card "
                  f"(tol 1e-5); {d} ticks = {r} graph replays for {f} hops ({f / d:.1f} hops a "
                  f"tick); per-hop round trip median {p50:.3f} ms, p99 {p99:.3f} ms, worst "
                  f"{worst:.3f} ms (host clock, client side); {f / wall:.0f} hops served a "
                  f"second ({wall:.3f} s wall); host time a tick (batcher: rows filled, copy "
                  f"in, replay, copy out enqueued) median {np.median(host):.3f} ms; tick submit "
                  f"to output on the host median {np.median(fetch):.3f} ms; against the 10 ms "
                  f"hop: p99 {'within' if p99 <= 10.0 else 'beyond'} it, worst "
                  f"{'within' if worst <= 10.0 else 'beyond'} it (information only)")
        tick64 = srv.measure_chip_tick(200)
        tick16 = small.measure_chip_tick(200)
        print(f"server tick on the device (measure_chip_tick: 200 chained graph replays, CUDA "
              f"events, every slot active) on {smi}: S=64 {tick64:.4f} ms, S=16 {tick16:.4f} ms "
              f"a tick, against the 10 ms hop")

        bridge = WsBridge(srv, port=0).start()
        try:
            page, hop_out = ws_round_trip(bridge.port, audio[0, :HOP])
        finally:
            bridge.stop()
        ws_err = float(np.abs(hop_out - ref[0, :HOP]).max()) if hop_out.size == HOP else np.inf
        if b"200 OK" not in page or b"DeepFilterNet" not in page or not ws_err <= 1e-5:
            fail(f"WebSocket bridge: page {page[:40]!r}, hop of {hop_out.size} samples, max abs "
                 f"err {ws_err:.3e} against the first hop on the card (tol 1e-5)")
        print(f"WebSocket bridge: demo page {len(page)} bytes over HTTP; one binary hop through "
              f"a WebSocket, max abs err {ws_err:.2e} against the same hop on the card "
              "(tol 1e-5)")
    finally:
        srv.stop()
    if k2.launches:
        fail(f"server path launched K2 {k2.launches} times")

    # the one card as a mesh (same width: bit for bit), then 16 slots split
    # into two shards of 8 on the one card (two graphs, both serving clients;
    # narrower products: within 1e-5 of the reference), whose replays the
    # server sums over its shards
    halves = Mesh((torch.device("cuda", 0),) * 2)
    for mesh, slots, want, tol, against in (
            (data_parallel_mesh(), SERVE_SLOTS, outs16, 0.0, "the unsharded server"),
            (halves, 16, ref[:16], 1e-5, "StreamingRuntime.process on the card")):
        msrv = StreamServer(model, df_state, port=0, max_streams=slots, mesh=mesh).start()
        try:
            got, _, _ = serve_clients(pool, msrv.port, audio[:16])
            diff = float(np.abs(got - want).max())
            d, r = msrv.dispatches, msrv.graph_replays
            shards = f"{mesh.size} shard(s) of {slots // mesh.size} slots"
            if (msrv.graph_captures != mesh.size or msrv.k1_in_graph != [1] * mesh.size
                    or not 0 < d or r != d * mesh.size or not diff <= tol):
                fail(f"mesh server, {shards}: {msrv.graph_captures} graphs, K1 in them "
                     f"{msrv.k1_in_graph}, {r} replays for {d} ticks (want {mesh.size} a tick), "
                     f"max abs diff {diff:.3e} from {against} (tol {tol})")
            replays += r
        finally:
            msrv.stop()
        print(f"server over {shards} on {len(set(mesh.devices))} device(s), 16 clients: "
              f"{msrv.graph_captures} graph(s), {r} replays for {d} ticks; max abs diff "
              f"{diff:.2e} from {against} (tol {tol})")
    print(f"serving path: K1 ran in {replays} graph replays (one launch each), K2 launches 0")
    return replays


# -- phase 8: the DFN2 and DFN1 families, and DeepFilterNet-MF ------------------

FAMILIES = ("pretrained/dfn2_fixture_demo", "pretrained/dfn1_fixture_demo")
FAMILY_ROWS = 16  # the offline and scan paths' rows
SERVE8_SLOTS, SERVE8_SECONDS = 16, 1.0


def k1_first_frame(rt, audio):
    """K1 against its plain version on a runtime's first frame (the fresh
    carry's memory and norm states, the first hop of every stream), each
    output within 1e-5 of its largest value, as phase 3 holds it. Returns
    the largest error over its tolerance."""
    from deepfilternet_torch.ops.fused_frontend import (
        fused_analysis_frontend,
        fused_analysis_frontend_plain,
    )

    carry = rt.init(audio.shape[0])
    frame = torch.from_numpy(np.ascontiguousarray(audio[:, :HOP])).to(rt.device)
    args = (carry.analysis_mem, frame, carry.mean_norm, carry.unit_norm)
    kw = dict(fft_size=rt.stft_cfg.fft_size, hop_size=rt.stft_cfg.hop_size, nb_erb=rt.nb_erb,
              nb_df=rt.nb_df, min_nb_erb_freqs=rt.df_state.min_nb_erb_freqs, alpha=rt.alpha,
              sr=rt.df_state.sr)
    got = fused_analysis_frontend(*args, **kw)
    ref = fused_analysis_frontend_plain(*args, **kw)
    torch.cuda.synchronize()
    worst = 0.0
    for a, b in zip(got, ref):
        if a.shape != b.shape or not torch.isfinite(a).all():
            fail(f"K1 on the first frame: shape {tuple(a.shape)} or non-finite values")
        ratio = float((a - b).abs().max()) / (1e-5 * max(float(b.abs().max()), 1e-30))
        worst = max(worst, ratio)
    if worst > 1.0:
        fail(f"K1 on the first frame: {worst:.2f} x its tolerance (1e-5 x max|plain|)")
    return worst


def family_path(card, smi, model_dir, audio, pool):
    """One bundled checkpoint of another family (DFN2, DFN1) on the card:
    offline enhance() on [16, 2 s] against the CPU; StreamingRuntime on the
    main path's 64 x 2 s (K1 once a frame, counted) against the CPU, with K1
    against its plain version on the first frame; enhance(backend="scan")
    against the offline output; ChunkedStreamingRuntime against the per-frame
    output; then, for DFN1, mask-only through the offline and per-frame
    paths against the CPU, and for DFN2 a 16-slot server (its tick one CUDA
    graph with K1 inside) against StreamingRuntime.process. Returns the
    kernels line's entries for this family."""
    from deepfilternet_torch.enhance import enhance, init_df
    from deepfilternet_torch.ops.fused_frontend import fused_analysis_frontend as k1
    from deepfilternet_torch.ops.whole_cell import cell_process as k2
    from deepfilternet_torch.streaming import ChunkedStreamingRuntime, StreamingRuntime

    model, df_state, suffix = init_df(model_dir)
    cpu_model, cpu_state, _ = init_df(model_dir, device="cpu")
    if model.device.type != "cuda":
        fail(f"init_df({model_dir}) put the model on {model.device}")
    fam = {"dfnet2": "DFN2", "dfnet1": "DFN1"}[model.module.__name__.rsplit(".", 1)[1]]
    tag = f"{fam} ({model_dir}, {suffix})"
    s, n_frames = audio.shape[0], audio.shape[1] // HOP
    batch = audio[:FAMILY_ROWS]
    entry = {}

    # offline: the whole-utterance forward, neither kernel
    enhance(model, df_state, batch)  # warm-up
    torch.cuda.synchronize()
    k1.launches = k2.launches = 0
    t0 = time.perf_counter()
    off = enhance(model, df_state, batch)
    wall = time.perf_counter() - t0
    if off.shape != batch.shape or not np.isfinite(off).all() or k1.launches or k2.launches:
        fail(f"{tag} offline: output {off.shape}, K1 {k1.launches}, K2 {k2.launches} launches")
    err = scale_err(off, enhance(cpu_model, cpu_state, batch))
    if not err <= 1e-4:
        fail(f"{tag} offline vs the CPU: {err:.3e} of the largest value > 1e-4")
    print(f"{tag} enhance() offline [{FAMILY_ROWS}, {SECONDS} s] on {card}: {wall:.3f} s wall, "
          f"RTF {FAMILY_ROWS * SECONDS / wall:.1f}x (information only); vs the CPU "
          f"{err:.3e} of the largest value (tol 1e-4); K1 and K2 launches 0")

    # per frame: K1 once a frame
    rt = StreamingRuntime(model, df_state)
    k1_ratio = k1_first_frame(rt, audio)
    rt.process(rt.init(s), audio[:, : 5 * HOP])  # warm-up
    torch.cuda.synchronize()
    k1.launches = 0
    t0 = time.perf_counter()
    _, out_dev = rt.process(rt.init(s), audio)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    entry["launches"] = k1.launches
    if k1.launches != n_frames:
        fail(f"{tag} per frame: K1 launches {k1.launches} != frames {n_frames}")
    out = out_dev.cpu().numpy()
    cpu_rt = StreamingRuntime(cpu_model, cpu_state)
    err = scale_err(out, cpu_rt.process(cpu_rt.init(s), audio)[1].numpy())
    if out.shape != audio.shape or not np.isfinite(out).all() or not err <= 1e-4:
        fail(f"{tag} per frame: output {out.shape}, vs the CPU {err:.3e} of the largest "
             "value (tol 1e-4)")
    print(f"{tag} StreamingRuntime.process S={s} x {SECONDS} s = {n_frames} frames on {card}: "
          f"K1 launches {entry['launches']}, {wall:.3f} s wall, aggregate RTF "
          f"{SECONDS * s / wall:.1f}x (information only); vs the CPU {err:.3e} of the largest "
          f"value (tol 1e-4); K1 against its plain version on the first frame: "
          f"{k1_ratio:.3f} x its tolerance (1e-5 x max|plain| an output)")
    entry["max_abs_err_first_frame_over_tol"] = k1_ratio
    profile_frames(rt, audio[:, : 20 * HOP], card, label=f"{fam} per-frame")

    # scan backend: the per-frame runtime behind enhance()
    k1.launches = 0
    t0 = time.perf_counter()
    scan = enhance(model, df_state, batch, backend="scan")
    wall = time.perf_counter() - t0
    n_scan = (batch.shape[1] + df_state.fft_size) // HOP
    err = float(np.abs(scan - off).max())
    if k1.launches != n_scan or scan.shape != batch.shape or not err <= 1e-4:
        fail(f"{tag} scan: K1 launches {k1.launches} (want {n_scan}), vs offline {err:.3e} "
             "(tol 1e-4)")
    print(f"{tag} enhance(backend='scan') [{FAMILY_ROWS}, {SECONDS} s]: K1 launches "
          f"{n_scan}, {wall:.3f} s wall (information only); vs the offline output max abs err "
          f"{err:.3e} (tol 1e-4)")

    # chunked: forward_chunk, no K1
    crt = ChunkedStreamingRuntime(model, df_state)
    crt.process(crt.init(s), audio[:, : 20 * HOP])  # warm-up
    torch.cuda.synchronize()
    k1.launches = 0
    t0 = time.perf_counter()
    _, cout = crt.process(crt.init(s), audio)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    err = float(np.abs(cout.cpu().numpy() - out).max())
    if k1.launches or not err <= 1e-4:
        fail(f"{tag} chunked: K1 launches {k1.launches}, vs per frame {err:.3e} (tol 1e-4)")
    print(f"{tag} ChunkedStreamingRuntime S={s} x {SECONDS} s in chunks of {crt.chunk_frames} "
          f"on {card}: {wall:.3f} s wall, aggregate RTF {SECONDS * s / wall:.1f}x (information "
          f"only); vs the per-frame output max abs err {err:.3e} (tol 1e-4); K1 launches 0")

    if fam == "DFN1":
        mmodel, mstate, _ = init_df(model_dir, mask_only=True)
        cmodel, cstate, _ = init_df(model_dir, mask_only=True, device="cpu")
        moff = enhance(mmodel, mstate, batch)
        e_off = scale_err(moff, enhance(cmodel, cstate, batch))
        mrt, cmrt = StreamingRuntime(mmodel, mstate), StreamingRuntime(cmodel, cstate)
        k1.launches = 0
        mout = mrt.process(mrt.init(FAMILY_ROWS), batch)[1].cpu().numpy()
        m_launches = k1.launches
        e_pf = scale_err(mout, cmrt.process(cmrt.init(FAMILY_ROWS), batch)[1].numpy())
        e_full = scale_err(moff, off)
        if not (e_off <= 1e-4 and e_pf <= 1e-4 and m_launches == n_frames and e_full > 1e-3):
            fail(f"{tag} mask-only: offline {e_off:.3e}, per frame {e_pf:.3e} vs the CPU "
                 f"(tol 1e-4), K1 {m_launches} (want {n_frames}), {e_full:.3e} from the full "
                 "model (want > 1e-3)")
        print(f"{tag} mask-only (init_df(mask_only=True)) [{FAMILY_ROWS}, {SECONDS} s]: "
              f"offline vs the CPU {e_off:.3e}, per frame vs the CPU {e_pf:.3e} of the largest "
              f"value (tol 1e-4), K1 launches {m_launches}; {e_full:.3e} from the full model")
    else:
        entry.update(served_family(tag, smi, model, df_state, audio, pool))
    return fam, entry


def served_family(tag, smi, model, df_state, audio, pool, clients=CLIENT_PROCS,
                  seconds=SERVE8_SECONDS):
    """A 16-slot server, each tick one CUDA-graph replay holding K1: `clients`
    clients in the spawned processes of `pool` stream `seconds` each, one hop
    a request, every one bit for bit equal to StreamingRuntime.process of a
    16-stream batch that holds its audio (the same batch width as the
    graph)."""
    from deepfilternet_torch.ops.fused_frontend import fused_analysis_frontend as k1
    from deepfilternet_torch.ops.whole_cell import cell_process as k2
    from deepfilternet_torch.serve import StreamServer
    from deepfilternet_torch.streaming import StreamingRuntime

    hop = df_state.hop_size
    n, hops = clients, int(seconds * SR) // hop
    clip = np.ascontiguousarray(audio[:n, : hops * hop])
    rows = np.zeros((SERVE8_SLOTS, clip.shape[1]), np.float32)
    rows[:n] = clip
    rt = StreamingRuntime(model, df_state)
    ref = rt.process(rt.init(SERVE8_SLOTS), rows)[1].cpu().numpy()[:n]
    k1.launches = k2.launches = 0
    srv = StreamServer(model, df_state, port=0, max_streams=SERVE8_SLOTS).start()
    try:
        got, rtt, wall = serve_clients(pool, srv.port, clip, hop)
        d, f, r = srv.dispatches, srv.frames_processed, srv.graph_replays
        diff = float(np.abs(got - ref).max())
        if (srv.graph_captures != 1 or srv.k1_in_graph != [1] or diff != 0.0
                or not (r == d and 0 < d < f and f == n * hops) or k2.launches):
            fail(f"{tag} server: {srv.graph_captures} graphs, K1 in the graph "
                 f"{srv.k1_in_graph}, {r} replays for {d} ticks and {f} hops, max abs diff "
                 f"{diff:.3e} from StreamingRuntime.process (want 0), K2 {k2.launches}")
    finally:
        srv.stop()
    print(f"{tag} server, {SERVE8_SLOTS} slots, {n} clients x {hops} hops of {hop} samples in "
          f"{CLIENT_PROCS} processes on {smi}: every client bit for bit equal to "
          f"StreamingRuntime.process; {d} ticks = {r} graph replays for {f} hops, K1 launches "
          f"recorded in the graph {srv.k1_in_graph}; round trip median "
          f"{np.percentile(rtt, 50):.3f} ms, p99 {np.percentile(rtt, 99):.3f} ms against the "
          f"{hop / SR * 1e3:.0f} ms hop, {wall:.3f} s wall (information only)")
    return {"server_replays": r, "k1_in_graph": srv.k1_in_graph == [1]}


def mvdr_cancellation(ifc, cov, order):
    """A bin and frame's cancellation factor of MVDR's denominator
    Re(ifc^H R ifc): the sum of its terms' magnitudes over its magnitude
    (float64, from the MF heads' outputs). Rounding errors of the terms reach
    the filter weights multiplied by it."""
    b, t, f, _ = ifc.shape
    ifc = ifc.astype(np.float64).reshape(b, t, f, order, 2)
    cov = cov.astype(np.float64).reshape(b, t, f, order, order, 2)
    ifc_c, cov_c = ifc[..., 0] + 1j * ifc[..., 1], cov[..., 0] + 1j * cov[..., 1]
    den = np.einsum("...n,...nm,...m->...", np.conj(ifc_c), cov_c, ifc_c).real
    mag = np.einsum("...n,...nm,...m->...", np.abs(ifc_c), np.abs(cov_c), np.abs(ifc_c))
    return mag / np.maximum(np.abs(den), 1e-300)


# MVDR divides by Re(ifc^H R ifc). With untrained weights R is no covariance,
# and on the main path's audio that sum cancels by a factor of 8 at the median
# bin and up to 8e5 at the worst: there the rounding of two correct float32
# runs is multiplied up (the port against JAX on the CPU, same features: 4.0e-3
# of the largest value over all bins, 1.8e-7 over the 96% of bins that cancel
# by at most 100). The low band is held at 1e-4 on the bins that cancel by at
# most MVDR_MAX_CANCELLATION (at least 90% of them); the whole output's error
# is printed.
MVDR_MAX_CANCELLATION = 100.0


def mf_path(card, audio):
    """DeepFilterNet-MF, WF and MVDR, at ModelParamsMF's default widths with
    init_df's seeded random weights (the repo has no MF checkpoint):
    enhance() on the card on [4, 2 s] (wall, finite output), then the offline
    forward on the same features on the card against the CPU, each output at
    1e-4 of its largest value (MVDR's low band: MVDR_MAX_CANCELLATION)."""
    from deepfilternet_torch.config import config
    from deepfilternet_torch.enhance import df_features, enhance, init_df

    x = audio[:4]
    for method in ("WF", "MVDR"):
        config.reset()
        config.set("MFOP_METHOD", method, section="deepfilternet")
        try:
            model, df_state, _ = init_df(model_name="deepfilternetmf")
            cpu_model, cpu_state, _ = init_df(model_name="deepfilternetmf", device="cpu")
        finally:
            config.reset()
        enhance(model, df_state, x)  # warm-up
        t0 = time.perf_counter()
        out = enhance(model, df_state, x)
        wall = time.perf_counter() - t0
        if out.shape != x.shape or not np.isfinite(out).all():
            fail(f"MF {method}: enhance() output {out.shape} not finite / not {x.shape}")
        feats = df_features(x, cpu_state, cpu_model.cfg["nb_df"], device="cpu")
        ref = cpu_model.module.forward(cpu_model.params, cpu_model.state, cpu_model.cfg, *feats)[0]
        got = model.module.forward(model.params, model.state, model.cfg,
                                   *(f.to(model.device) for f in feats))[0]
        ref = [v.numpy() for v in (ref[0], ref[1], ref[2], *ref[3])]
        got = [v.cpu().numpy() for v in (got[0], got[1], got[2], *got[3])]
        errs = {name: scale_err(g, r) for name, g, r in
                zip(("spec_e", "mask", "lsnr", "ifc", "cov"), got, ref)}
        nb_df = model.cfg["nb_df"]
        scale = float(np.abs(ref[0]).max())
        low = np.abs(got[0][..., :nb_df, :] - ref[0][..., :nb_df, :]).max(-1)
        note = ""
        if method == "MVDR":
            well = (mvdr_cancellation(ref[3], ref[4], model.cfg["df_order"])
                    <= MVDR_MAX_CANCELLATION)
            gated = dict(errs, spec_e=max(float(low[well].max()) / scale,
                                          float(np.abs(got[0][..., nb_df:, :]
                                                       - ref[0][..., nb_df:, :]).max()) / scale))
            if not well.mean() >= 0.9:
                fail(f"MF MVDR: only {well.mean():.1%} of the low-band bins cancel by at most "
                     f"{MVDR_MAX_CANCELLATION}")
            note = (f"; spec_e over all bins {errs['spec_e']:.3e} (information: "
                    f"{1 - well.mean():.2%} of the low-band bins cancel by more than "
                    f"{MVDR_MAX_CANCELLATION:.0f}, gated on the rest)")
        else:
            gated = errs
        bad = {k: v for k, v in gated.items() if not v <= 1e-4}
        if bad:
            fail(f"MF {method}: card vs CPU beyond 1e-4 of the largest value: {bad}")
        print(f"MF {method} (deepfilternetmf, seeded random weights, published widths): "
              f"enhance() [4, {SECONDS} s] on {card} {wall:.3f} s wall, RTF "
              f"{4 * SECONDS / wall:.1f}x (information only); forward on the same features, "
              "card vs CPU, of each output's largest value (tol 1e-4): "
              + ", ".join(f"{k} {v:.2e}" for k, v in gated.items()) + note)


def families_path(card, smi, audio):
    """Phase 8. Returns {family: its kernels-line entries}."""
    import multiprocessing as mp

    out = {}
    with mp.get_context("spawn").Pool(CLIENT_PROCS) as pool:
        pool.map(_client_process_ready, range(4 * CLIENT_PROCS), chunksize=1)
        for model_dir in FAMILIES:
            fam, entry = family_path(card, smi, model_dir, audio, pool)
            out[fam] = entry
    mf_path(card, audio)
    return out


# -- phase 9: training ------------------------------------------------------------

# the fixture-demo loss stack (the JAX package's scripts/train_demo.py) and
# the multi-resolution loss, whose time-domain round trip (loss_istft) and
# hann STFTs then run on the card too; DfAlphaLoss for DFN2 and DFN1
TRAIN_LOSS = (("SpectralLoss", "factor_magnitude", "100"),
              ("SpectralLoss", "factor_complex", "100"), ("SpectralLoss", "gamma", "0.6"),
              ("MaskLoss", "factor", "1"), ("LocalSnrLoss", "factor", "0.0005"),
              ("MultiResSpecLoss", "factor", "500"),
              ("MultiResSpecLoss", "fft_sizes", "256,512,1024"))
TRAIN_SECONDS, FAMILY_TRAIN_SECONDS = 3.0, 2.0
TRAIN_STEPS = 20


def train_batch(df_state, nb_df, rows, seconds, seed, dev):
    """Seeded harmonic-plus-noise speech as clean, seeded white noise added
    at 0-10 dB SNR; spectra and features from the port's offline
    df_features on `dev`, as the train step takes them."""
    from deepfilternet_torch.enhance import df_features

    clean = noisy_speech_like(rows, seconds, seed)
    rng = np.random.default_rng(seed + 1000)
    noise = rng.standard_normal(clean.shape)
    snr_db = rng.uniform(0.0, 10.0, (rows, 1))
    noise *= np.sqrt(np.mean(clean ** 2, 1, keepdims=True) / np.mean(noise ** 2, 1, keepdims=True)
                     / 10 ** (snr_db / 10))
    spec, feat_erb, feat_spec = df_features((clean + noise).astype(np.float32), df_state, nb_df,
                                            device=dev)
    clean_spec = df_features(clean, df_state, nb_df, device=dev)[0]
    return {"noisy": spec, "clean": clean_spec, "feat_erb": feat_erb, "feat_spec": feat_spec}


def train_model(model_dir=None, name=None, dev="cuda", keys=None):
    """(params, state, cfg, module, df_state) through init_model, with a
    bundled checkpoint's weights through read_cp (seeded random weights
    without a directory), on `dev`, under the config `keys` {(key, section):
    value}; the loss stack set in the config."""
    from deepfilternet_torch.checkpoint import params_from_numpy, read_cp
    from deepfilternet_torch.config import config
    from deepfilternet_torch.enhance import DfState
    from deepfilternet_torch.models import init_model

    config.reset()
    if model_dir is not None:
        config.load(os.path.join(model_dir, "config.ini"), allow_reload=True)
    for (key, section), value in (keys or {}).items():
        config.set(key, value, section=section)
    params, state, cfg, module = init_model(name, seed=7, device=dev)
    if model_dir is not None:
        payload = read_cp(os.path.join(model_dir, "checkpoints"), "best")
        params, ckpt_state = params_from_numpy(payload["params"], payload["state"], dev)
        state = ckpt_state or state
    for section, key, value in TRAIN_LOSS + (("DfAlphaLoss", "factor", "1"),):
        config.set(key, value, section=section)
    df_state = DfState(sr=config("SR", 48000, int, section="DF"),
                       fft_size=config("FFT_SIZE", 960, int, section="DF"),
                       hop_size=config("HOP_SIZE", 480, int, section="DF"), nb_erb=cfg["nb_erb"],
                       min_nb_erb_freqs=config("MIN_NB_ERB_FREQS", 2, int, section="DF"))
    return params, state, cfg, module, df_state


def train_loss(cfg, df_state):
    from deepfilternet_torch.train.loss import Loss

    return Loss(df_state.stft_cfg, df_state.erb_widths, cfg["nb_df"],
                (cfg["lsnr_min"], cfg["lsnr_max"]))


@contextlib.contextmanager
def recorded_clip():
    """Each train step's gradients as they reach the global-norm clip
    (copies) and the norm it took, by wrapping the trainer's clip."""
    from deepfilternet_torch.train import trainer

    real, seen = trainer.clip_by_global_norm_, []

    def record(grads, max_norm):
        copies = [g.detach().clone() for g in grads]
        norm = real(grads, max_norm)
        seen.append((copies, float(norm)))
        return norm

    trainer.clip_by_global_norm_ = record
    try:
        yield seen
    finally:
        trainer.clip_by_global_norm_ = real


def named_leaves(tree, prefix=""):
    """(dotted path, tensor) of every leaf, dict keys sorted: the trainer's
    leaf order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in named_leaves(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in named_leaves(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def grad_scales(params, grads):
    """The scale each gradient leaf is held to: its largest |g|, but for a
    1x1 per-channel conv weight [C, 1, 1, 1] under a batch norm, whose
    gradient the norm cancels (the terms cancel but for a factor
    eps / (w^2 var + eps), leaving mostly their rounding), its block's."""
    leaves = named_leaves(params)
    block = {}
    for (path, _), g in zip(leaves, grads):
        top = path.split(".")[0]
        block[top] = max(block.get(top, 0.0), float(g.abs().max()))
    return [block[path.split(".")[0]]
            if tuple(t.shape[1:]) == (1, 1, 1) and "bn" in params[path.split(".")[0]]
            else float(g.abs().max()) for (path, t), g in zip(leaves, grads)]


def step_vs_cpu(tag, card, module, cfg, df_state, params, state, cpu_params, cpu_state, batch,
                lr, wd):
    """One train step on the card and on the CPU from the same numbers and
    batch, through the port. Checks the loss (relative 1e-5), every gradient
    leaf (1e-3 of its scale, `grad_scales`: cuDNN's convolutions and GRU sum
    in another order), the batch-norm running statistics (1e-5 of
    max(1, |x|)), the parameters after the step (within 2 lr: Adam's first
    step is close to lr sign(g), and a near-zero gradient may round to the
    other sign; 99.9% within 1e-6 + 1e-3 lr), and that every GRU weight leaf
    has a gradient on the card. Returns the card's TrainState."""
    from deepfilternet_torch.train.trainer import (
        init_train_state,
        make_optimizer,
        make_train_step,
    )

    out = {}
    for side, p, s, b in (("card", params, state, batch),
                          ("cpu", cpu_params, cpu_state, {k: v.cpu() for k, v in batch.items()})):
        with recorded_clip() as seen:
            ts = init_train_state(p, s, make_optimizer())
            ts, met = make_train_step(module, cfg, train_loss(cfg, df_state))(ts, b, lr, wd)
        if not bool(met["finite"]) or len(seen) != 1:
            fail(f"{tag} train step on the {side}: loss {float(met['loss'])}, not finite")
        out[side] = (ts, met, seen[0][0])
    (ts, met, grads), (cts, cmet, cgrads) = out["card"], out["cpu"]
    loss_err = abs(float(met["loss"]) - float(cmet["loss"])) / abs(float(cmet["loss"]))
    grad_err, dead = 0.0, []
    for (path, _), g, cg, scale in zip(named_leaves(params), grads, cgrads,
                                       grad_scales(cpu_params, cgrads)):
        grad_err = max(grad_err, float((g.cpu() - cg).abs().max()) / max(scale, 1e-30))
        if "gru" in path and not bool(g.abs().max() > 0):
            dead.append(path)
    bn_err = max(float((ts.model_state[k]["bn"][x].cpu() - v["bn"][x]).abs().max())
                 / max(1.0, float(v["bn"][x].abs().max()))
                 for k, v in cts.model_state.items() for x in ("mean", "var"))
    d = torch.cat([(t.detach().cpu() - c.detach()).abs().ravel() for (_, t), (_, c)
                   in zip(named_leaves(ts.params), named_leaves(cts.params))])
    near = float((d <= 1e-6 + 1e-3 * lr).double().mean())
    print(f"{tag} one train step, card vs CPU from the same weights and batch "
          f"({tuple(batch['noisy'].shape)}), {card}: loss {float(met['loss']):.6f}, rel err "
          f"{loss_err:.2e} (tol 1e-5); gradients {grad_err:.2e} of each leaf's scale (tol 1e-3, "
          f"{len(grads)} leaves); batch-norm statistics {bn_err:.2e} (tol 1e-5); parameters after "
          f"the step max {float(d.max()):.2e} (tol 2 lr = {2 * lr:.0e}), {near:.4%} within "
          f"1e-6 + 1e-3 lr (want 99.9%); GRU leaves with a zero gradient on the card: {len(dead)}")
    if dead:
        fail(f"{tag}: GRU weights with an all-zero gradient on the card: {dead}")
    if not (loss_err <= 1e-5 and grad_err <= 1e-3 and bn_err <= 1e-5
            and float(d.max()) <= 2 * lr and near >= 0.999):
        fail(f"{tag}: the card's train step is beyond its tolerance of the CPU's")
    return ts, met


def timed_steps(tag, card, smi, step, ts, batch, lr, wd, n):
    """`n` steps on one batch: loss finite on each and falling, no NaN
    skipped; median step time (CUDA events, each step ends in the host's
    wait for its finite check), device busy share and ops a step (profiler),
    peak memory. Returns the TrainState."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        ts, met = step(ts, batch, lr, wd)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        losses.append(float(met["loss"]))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0] and ts.nan_count == 0):
        fail(f"{tag}: {n} steps, losses {losses}, NaN skips {ts.nan_count}")
    rows, frames = batch["noisy"].shape[:2]
    print(f"{tag} {n} train steps on one batch [{rows}, {frames} frames] on {smi}: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} (falls: yes), NaN skips 0; step median "
          f"{float(np.median(times)):.2f} ms (min {min(times):.2f}, max {max(times):.2f}; CUDA "
          f"events), peak memory {peak:.2f} GiB")
    holder = {}

    def one():
        holder["ts"] = step(ts, batch, lr, wd)[0]

    profile_call(one, f"{tag} one train step", smi, rows * frames * HOP / SR)
    return holder["ts"]


def nan_guard(tag, step, ts, batch, lr, wd):
    """A NaN batch: parameters, batch-norm state and the optimizer's state
    dict stay bit for bit; nan_count goes up by one."""
    bad = dict(batch, noisy=torch.full_like(batch["noisy"], float("nan")))
    params = [t.detach().clone() for _, t in named_leaves(ts.params)]
    before = ts.opt_state.state_dict()
    opt = {i: {k: v.clone() if torch.is_tensor(v) else v for k, v in st.items()}
           for i, st in before["state"].items()}
    groups = [dict(g) for g in before["param_groups"]]
    ts2, met = step(ts, bad, lr, wd)
    after = ts2.opt_state.state_dict()
    same = (not bool(met["finite"]) and ts2.nan_count == ts.nan_count + 1
            and ts2.model_state is ts.model_state
            and all(torch.equal(a, t) for a, (_, t) in zip(params, named_leaves(ts2.params)))
            and after["param_groups"] == groups and after["state"].keys() == opt.keys()
            and all(torch.equal(v, after["state"][i][k]) if torch.is_tensor(v)
                    else v == after["state"][i][k] for i, st in opt.items() for k, v in st.items()))
    print(f"{tag} a NaN batch: finite {bool(met['finite'])}, nan_count {ts.nan_count} -> "
          f"{ts2.nan_count}; parameters, batch-norm state and optimizer state bit for bit "
          f"unchanged: {'yes' if same else 'NO'}")
    if not same:
        fail(f"{tag}: the NaN guard changed the state")
    return ts2


def mask_only_step(tag, module, cfg, df_state, params, state, batch, lr, wd):
    """One MASK_ONLY step (trainable_filter(mask_only=True)): every
    DF-decoder leaf bit for bit unchanged, the others trained, and the clip
    norm over all gradients, frozen ones included."""
    from deepfilternet_torch.train.trainer import (
        DF_DECODER_KEYS,
        init_train_state,
        make_optimizer,
        make_train_step,
        trainable_filter,
    )

    ts = init_train_state(params, state, make_optimizer())
    before = [t.detach().clone() for _, t in named_leaves(ts.params)]
    step = make_train_step(module, cfg, train_loss(cfg, df_state),
                           trainable=trainable_filter(mask_only=True))
    with recorded_clip() as seen:
        ts, met = step(ts, batch, lr, wd)
    leaves = named_leaves(ts.params)
    frozen = [p.split(".")[0] in DF_DECODER_KEYS for p, _ in leaves]
    kept = [torch.equal(b, t) for b, (_, t) in zip(before, leaves)]
    grads, norm = seen[0]
    sq = [float((g.double() ** 2).sum()) for g in grads]
    norm_all = float(np.sqrt(sum(sq)))
    norm_trained = float(np.sqrt(sum(s for s, f in zip(sq, frozen) if not f)))
    apart = abs(norm_all - norm_trained) > 2e-6 * norm_all
    ok = (bool(met["finite"]) and len(grads) == len(leaves) and any(frozen)
          and all(k for k, f in zip(kept, frozen) if f) and not all(k for k, f in zip(kept, frozen)
                                                                   if not f)
          and abs(norm - norm_all) <= 1e-6 * norm_all
          and (not apart or abs(norm - norm_trained) > abs(norm - norm_all)))
    print(f"{tag} MASK_ONLY step: {sum(frozen)} DF-decoder leaves bit for bit unchanged: "
          f"{all(k for k, f in zip(kept, frozen) if f)}, {sum(not k for k in kept)} of "
          f"{len(leaves)} leaves trained; clip norm {norm:.6f}, over all {len(grads)} gradients "
          f"{norm_all:.6f} (float64), over the trained ones only {norm_trained:.6f}")
    if not ok:
        fail(f"{tag}: MASK_ONLY froze or clipped wrongly")


def trained_inference(tag, card, ts, audio, k1_count, dev):
    """The trained weights through the inference path: write_cp and
    config.save into a model directory, init_df on it, enhance() offline
    (pad=False) against StreamingRuntime.process (K1 once a frame) at 1e-4.
    Returns K1's launches in the per-frame run."""
    from deepfilternet_torch.checkpoint import write_cp
    from deepfilternet_torch.config import config
    from deepfilternet_torch.enhance import enhance, init_df
    from deepfilternet_torch.streaming import StreamingRuntime

    rows, n_frames = FAMILY_ROWS, audio.shape[1] // HOP
    x = audio[:rows]
    with tempfile.TemporaryDirectory() as model_dir:
        write_cp(os.path.join(model_dir, "checkpoints"), ts.params, ts.model_state, ts.step,
                 is_best=True)
        config.save(os.path.join(model_dir, "config.ini"))
        model, mstate, suffix = init_df(model_dir, device=dev)
    same = all(torch.equal(a.detach(), b) for (_, a), (_, b)
               in zip(named_leaves(ts.params), named_leaves(model.params)))
    off = enhance(model, mstate, x, pad=False)
    rt = StreamingRuntime(model, mstate)
    k1_count.launches = 0
    _, out = rt.process(rt.init(rows), x)
    torch.cuda.synchronize()
    launches = k1_count.launches
    err = float(np.abs(out.cpu().numpy() - off).max())
    print(f"{tag} trained weights written (write_cp, config.save) and loaded by init_df "
          f"({suffix}), bit for bit: {same}; enhance() offline vs StreamingRuntime.process "
          f"[{rows}, {x.shape[1] / SR} s] on {card}: max abs err {err:.3e} (tol 1e-4), K1 launches "
          f"{launches} in {n_frames} frames")
    if not (same and suffix == f"e{ts.step}" and np.isfinite(off).all() and err <= 1e-4
            and launches == n_frames):
        fail(f"{tag}: the trained model does not run through the inference path")
    return launches


def family_training(card, fam, model_dir, name, lr, wd, dev):
    """DFN2/DFN1 from their bundled checkpoints, MF with seeded weights: one
    step against the CPU, then 3 steps on the card at B=4 x 2 s, loss finite
    and (DFN2, DFN1) the DF alpha's part present."""
    from deepfilternet_torch.train.trainer import make_train_step

    params, state, cfg, module, df_state = train_model(model_dir, name, dev=dev)
    cpu_params, cpu_state, _, _, _ = train_model(model_dir, name, dev="cpu")
    batch = train_batch(df_state, cfg["nb_df"], 4, FAMILY_TRAIN_SECONDS, seed=41, dev=dev)
    ts, met = step_vs_cpu(fam, card, module, cfg, df_state, params, state, cpu_params, cpu_state,
                          batch, lr, wd)
    step = make_train_step(module, cfg, train_loss(cfg, df_state))
    losses = [float(met["loss"])]
    for _ in range(2):
        ts, met = step(ts, batch, lr, wd)
        losses.append(float(met["loss"]))
    alpha = "df_alpha" in met
    print(f"{fam} 3 train steps [4, {FAMILY_TRAIN_SECONDS} s] on {card}: losses "
          + ", ".join(f"{v:.4f}" for v in losses)
          + f"; parts {sorted(k for k in met if k not in ('loss', 'finite'))}")
    if not (np.all(np.isfinite(losses)) and alpha == (fam != "MF")):
        fail(f"{fam}: losses {losses}, df_alpha part present: {alpha}")


def training_path(card, smi, audio, dev="cuda"):
    """Phase 9. Returns K1's launches in the trained model's per-frame run."""
    from deepfilternet_torch.ops.fused_frontend import fused_analysis_frontend as k1
    from deepfilternet_torch.ops.whole_cell import cell_process as k2
    from deepfilternet_torch.train.trainer import load_opt_config, make_train_step

    opt_cfg = load_opt_config()
    lr, wd = opt_cfg["lr"], opt_cfg["weight_decay"]
    params, state, cfg, module, df_state = train_model(MODEL_DIR, dev=dev)
    cpu_params, cpu_state, _, _, _ = train_model(MODEL_DIR, dev="cpu")
    tag = f"DFN3 ({MODEL_DIR})"
    batch = train_batch(df_state, cfg["nb_df"], 4, TRAIN_SECONDS, seed=31, dev=dev)
    step_vs_cpu(tag, card, module, cfg, df_state, params, state, cpu_params, cpu_state, batch,
                lr, wd)

    from deepfilternet_torch.train.trainer import init_train_state, make_optimizer

    batch8 = train_batch(df_state, cfg["nb_df"], 8, TRAIN_SECONDS, seed=32, dev=dev)
    step = make_train_step(module, cfg, train_loss(cfg, df_state))
    ts = init_train_state(params, state, make_optimizer())
    k1.launches = k2.launches = 0
    ts = timed_steps(tag, card, smi, step, ts, batch8, lr, wd, TRAIN_STEPS)
    print(f"{tag} training launches K1 {k1.launches} and K2 {k2.launches} times")
    if k1.launches or k2.launches:
        fail(f"{tag}: the train steps launched K1 {k1.launches}, K2 {k2.launches} times")
    ts = nan_guard(tag, step, ts, batch8, lr, wd)
    launches = trained_inference(tag, card, ts, audio, k1, dev)
    mask_only_step(tag, module, cfg, df_state, params, state, batch, lr, wd)
    for fam, model_dir, name in (("DFN2", "pretrained/dfn2_fixture_demo", None),
                                 ("DFN1", "pretrained/dfn1_fixture_demo", None),
                                 ("MF", None, "deepfilternetmf")):
        family_training(card, fam, model_dir, name, lr, wd, dev)
    return launches


# -- phase 10: corpus training ------------------------------------------------------

# (clips, seconds) of each corpus file; "valid" is a speech file of its own
CORPUS = {"speech": (64, 5.0), "noise": (32, 10.0), "rir": (8, 0.5), "valid": (16, 5.0)}
# the demo's config.ini, with these [train] and [distortion] keys and the
# loss stack of phase 9
CORPUS_TRAIN = (("train", "MAX_EPOCHS", "2"), ("train", "BATCH_SIZE", "8"),
                ("train", "MAX_SAMPLE_LEN_S", "3"), ("train", "EARLY_STOPPING_PATIENCE", "5"),
                ("distortion", "p_reverb", "0.2"))
CORPUS_WORKERS, CORPUS_BATCH, PRELOADED_STEPS = 4, 8, 5


def write_corpus(root, corpus=CORPUS):
    """Seeded WAVs (phase 9's harmonic-plus-noise speech, amplitude-modulated
    white noise, decaying-noise RIRs) written by the port's save_audio and
    turned into int16 corpora by the port's prepare_data (its own HDF5
    writer); then every key read back through Hdf5Dataset, which must give
    prepare_data's int16 samples bit for bit. Returns the samples' bytes."""
    from deepfilternet_torch.data.hdf5 import Hdf5Dataset
    from deepfilternet_torch.scripts.prepare_data import prepare, sanitize_key
    from deepfilternet_torch.utils.audio_io import load_audio, save_audio

    wav = os.path.join(root, "wav")
    os.makedirs(wav)
    rng = np.random.default_rng(100)
    nbytes = 0
    for seed, (name, (n, seconds)) in enumerate(corpus.items()):
        t = np.arange(int(seconds * SR)) / SR
        if name in ("speech", "valid"):
            clips = noisy_speech_like(n, seconds, seed=200 + seed)
        elif name == "noise":
            clips = (rng.standard_normal((n, t.size)) * rng.uniform(0.02, 0.2, (n, 1))
                     * (1.0 + 0.5 * np.sin(2 * np.pi * rng.uniform(0.1, 2.0, (n, 1)) * t)))
        else:
            clips = (rng.standard_normal((n, t.size)) * 0.5
                     * np.exp(-t / rng.uniform(0.03, 0.15, (n, 1))))
        paths = []
        for i, x in enumerate(clips):
            paths.append(os.path.join(wav, f"{name}_{i:03d}.wav"))
            save_audio(paths[-1], x, SR)
        path = os.path.join(root, f"{name}.hdf5")
        group = "speech" if name == "valid" else name
        prepare(group, path, paths)
        ds = Hdf5Dataset(path)
        for p in paths:
            audio, _ = load_audio(p)
            want = np.clip(audio * 32767.0, -32768, 32767).astype(np.int16)
            got = ds.read(group, sanitize_key(p))
            if not np.array_equal(got, want.astype(np.float32) / 32768.0):
                fail(f"corpus {name}: {p} does not read back bit for bit")
            nbytes += want.nbytes
        ds.close()
    with open(os.path.join(root, "dataset.cfg"), "w") as f:
        rest = [["noise.hdf5", 1], ["rir.hdf5", 1]]
        json.dump({"train": [["speech.hdf5", 1]] + rest, "valid": [["valid.hdf5", 1]] + rest,
                   "test": [["valid.hdf5", 1]] + rest}, f)
    return nbytes


def corpus_loader_check(smi, root, nb_erb, nb_df, dev):
    """One epoch of DataLoader(FdDataset(TdDataset)) at 1 and CORPUS_WORKERS
    workers, as train() builds it: batches bit for bit equal, samples a
    second; FdDataset's features against the port's torch stft, erb_feat and
    spec_feat on `dev` (1e-5, 1e-4, 1e-4, as the JAX package's own data
    tests hold its numpy features). Returns (the first batch, samples a
    second at CORPUS_WORKERS)."""
    from deepfilternet_torch.data.dataloader import DataLoader
    from deepfilternet_torch.data.dataset import DatasetConfig, FdDataset, TdDataset
    from deepfilternet_torch.ops.features import erb_feat, spec_feat
    from deepfilternet_torch.ops.stft import Stft, stft

    cfgs = DatasetConfig.open(os.path.join(root, "dataset.cfg")).split("train")
    td = TdDataset(root, cfgs, "train", sr=SR, max_len_s=3.0, p_reverb=0.2, seed=42)
    fd = FdDataset(td, 960, HOP, nb_erb, nb_df)
    epochs, rates = {}, {}
    for workers in (1, CORPUS_WORKERS):
        loader = DataLoader(fd, CORPUS_BATCH, num_workers=workers, drop_last=True)
        t0 = time.perf_counter()
        epochs[workers] = list(loader.iter_epoch("train", 0))
        rates[workers] = len(epochs[workers]) * CORPUS_BATCH / (time.perf_counter() - t0)
    fields = ("speech", "noisy", "spec_clean", "spec_noisy", "feat_erb", "feat_spec", "lengths",
              "max_freq", "snr", "gain", "ids")
    same = len(epochs[1]) == len(epochs[CORPUS_WORKERS]) == len(td) // CORPUS_BATCH and all(
        np.array_equal(getattr(a, f), getattr(b, f))
        for a, b in zip(epochs[1], epochs[CORPUS_WORKERS]) for f in fields)
    first = epochs[CORPUS_WORKERS][0]
    cfg = Stft(sr=SR, fft_size=960, hop_size=HOP)
    spec = stft(torch.from_numpy(first.noisy).to(dev), cfg)
    errs = (float((spec.cpu() - torch.from_numpy(first.spec_noisy)).abs().max()),
            float((erb_feat(spec, fd.widths, fd.alpha).cpu()
                   - torch.from_numpy(first.feat_erb)).abs().max()),
            float((spec_feat(spec, nb_df, fd.alpha).cpu()
                   - torch.from_numpy(first.feat_spec)).abs().max()))
    print(f"corpus loader, one epoch of {len(td)} samples x 3 s in batches of {CORPUS_BATCH} "
          f"(host numpy, {os.cpu_count()} host cores): {rates[1]:.1f} samples/s at 1 worker, "
          f"{rates[CORPUS_WORKERS]:.1f} at {CORPUS_WORKERS}; batches bit for bit equal: {same}; "
          f"FdDataset against the port's stft / erb_feat / spec_feat on {smi}: {errs[0]:.2e} "
          f"(tol 1e-5) / {errs[1]:.2e} (tol 1e-4) / {errs[2]:.2e} (tol 1e-4)")
    if not (same and errs[0] <= 1e-5 and errs[1] <= 1e-4 and errs[2] <= 1e-4):
        fail("the corpus loader's batches or features are wrong")
    return first, rates[CORPUS_WORKERS]


@contextlib.contextmanager
def timed_run_steps():
    """Each step train() takes: its device time (CUDA events; the step ends
    in the host's wait for its finite check), its loss, and the host clock
    at its start and end (between two steps the host waits for the loader
    and copies the batch to the card)."""
    from deepfilternet_torch.train import run

    real, log = run.make_train_step, []

    def make(*args, **kwargs):
        step = real(*args, **kwargs)

        def timed(ts, batch, lr, wd):
            t0 = time.perf_counter()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            ts, met = step(ts, batch, lr, wd)
            end.record()
            end.synchronize()
            log.append({"ms": start.elapsed_time(end), "t0": t0, "t1": time.perf_counter(),
                        "loss": float(met["loss"])})
            return ts, met

        return timed

    run.make_train_step = make
    try:
        yield log
    finally:
        run.make_train_step = real


def run_train(label, *args, **kwargs):
    """train() with its standard output captured and echoed with `label`.
    Returns (test loss, the lines it printed)."""
    import io

    from deepfilternet_torch.train.run import train

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _, test_loss = train(*args, **kwargs)
    lines = out.getvalue().splitlines()
    for line in lines:
        print(f"  {label}: {line}")
    return test_loss, lines


def corpus_training_path(card, smi, dev="cuda"):
    """Phase 10. Returns the launches of K1 and K2 over the train() calls."""
    from deepfilternet_torch.checkpoint import read_cp, write_cp
    from deepfilternet_torch.config import config
    from deepfilternet_torch.data import _native
    from deepfilternet_torch.ops.fused_frontend import fused_analysis_frontend as k1
    from deepfilternet_torch.ops.whole_cell import cell_process as k2
    from deepfilternet_torch.train.run import batch_to_arrays, to_device
    from deepfilternet_torch.train.trainer import (
        init_train_state,
        load_opt_config,
        make_optimizer,
        make_train_step,
    )
    from scipy.signal import lfilter

    # the native data library: built from native/, never the scipy fallback
    t0 = time.perf_counter()
    if not _native.available():
        fail("native/libdfdata.so did not build (make -C native)")
    x = np.random.default_rng(3).standard_normal(48000).astype(np.float32)
    coefs = np.array([[0.2, 0.4, 0.2, 1.0, -0.6, 0.3], [1.0, -1.9, 0.95, 1.0, -1.8, 0.85]])
    want = x
    for c in coefs:  # the wrapper's plain version: lfilter a section, float32 between
        want = lfilter(c[:3] / c[3], [1.0, c[4] / c[3], c[5] / c[3]],
                       want.astype(np.float64)).astype(np.float32)
    err = float(np.abs(_native.biquad_chain(x, coefs) - want).max())
    print(f"native data library built in {time.perf_counter() - t0:.1f} s; biquad_chain of 2 "
          f"sections on 48000 samples against scipy's lfilter: {err:.2e} (tol 1e-6)")
    if err > 1e-6:
        fail("biquad_chain disagrees with lfilter")

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        nbytes = write_corpus(root)
        print(f"corpus written by the port's prepare_data (no h5py) and read back bit for bit "
              f"through Hdf5Dataset: " + ", ".join(f"{k} {n} x {s} s" for k, (n, s) in
                                                   CORPUS.items())
              + f"; {nbytes / 1e6:.1f} MB of int16 samples, "
              f"{sum(os.path.getsize(os.path.join(root, f'{k}.hdf5')) for k in CORPUS) / 1e6:.1f}"
              f" MB of HDF5; {time.perf_counter() - t0:.1f} s wall")

        params, state, cfg, module, df_state = train_model(MODEL_DIR, dev=dev)
        first, loader_rate = corpus_loader_check(smi, root, cfg["nb_erb"], cfg["nb_df"], dev)

        # the first corpus batch: one step card against CPU, then steps on the
        # batch held on the card (the train step without the loader)
        opt_cfg = load_opt_config()
        lr, wd = opt_cfg["lr"], opt_cfg["weight_decay"]
        batch = to_device(batch_to_arrays(first), dev)
        cpu_params, cpu_state, _, _, _ = train_model(MODEL_DIR, dev="cpu")
        step_vs_cpu("DFN3 first corpus batch", card, module, cfg, df_state, params, state,
                    cpu_params, cpu_state, batch, lr, wd)
        step = make_train_step(module, cfg, train_loss(cfg, df_state))
        ts = init_train_state(params, state, make_optimizer())
        pre = []
        for _ in range(PRELOADED_STEPS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            ts, _ = step(ts, batch, lr, wd)
            end.record()
            end.synchronize()
            pre.append(start.elapsed_time(end))

        # train(): the demo's config and checkpoint (as epoch 0) in base_dir
        base = os.path.join(root, "run")
        config.reset()
        config.load(os.path.join(MODEL_DIR, "config.ini"), allow_reload=True)
        for section, key, value in CORPUS_TRAIN + TRAIN_LOSS:
            config.set(key, value, section=section)
        os.makedirs(base)
        config.save(os.path.join(base, "config.ini"))
        demo = read_cp(os.path.join(MODEL_DIR, "checkpoints"), "best")
        write_cp(os.path.join(base, "checkpoints"), demo["params"], demo["state"], 0)
        ds_cfg = os.path.join(root, "dataset.cfg")
        k1.launches = k2.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with timed_run_steps() as log:
            test_loss, lines = run_train("train()", ds_cfg, root, base,
                                         num_workers=CORPUS_WORKERS)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        ckpts = sorted(os.listdir(os.path.join(base, "checkpoints")))
        best = open(os.path.join(base, "checkpoints", ".best")).read().split()
        summary = os.listdir(os.path.join(base, "summaries", "epoch_1"))
        n_steps = CORPUS["speech"][0] // CORPUS_BATCH
        ok = (len(log) == n_steps and np.all(np.isfinite([e["loss"] for e in log]))
              and np.isfinite(test_loss) and "Resuming from epoch 0" in lines
              and any(c.startswith("model_1.ckpt") for c in ckpts)
              and best[:1] == ["1"] and np.isfinite(float(best[1]))
              and all(any(n.startswith(f"0_{kind}_snr") and n.endswith(".wav") for n in summary)
                      for kind in ("noisy", "clean", "enh")))
        print(f"train() from the demo checkpoint (epoch 0) over the corpus on {smi}: epoch 1 in "
              f"{len(log)} steps [{CORPUS_BATCH}, 3 s], losses {log[0]['loss']:.4f} .. "
              f"{log[-1]['loss']:.4f}, valid {float(best[1]):.4f}, test {test_loss:.4f}; "
              f"checkpoints {ckpts}, .best {best}; summaries {sorted(summary)[:3]}...; "
              f"wall {wall:.1f} s, peak memory {peak:.2f} GiB")
        if not ok:
            fail("train() over the corpus did not train, evaluate or write as it should")
        steps_ms = [e["ms"] for e in log]
        gaps_ms = [(b["t0"] - a["t1"]) * 1e3 for a, b in zip(log, log[1:])]
        epoch_s = log[-1]["t1"] - log[0]["t0"]
        print(f"train() step median {np.median(steps_ms):.2f} ms (min {min(steps_ms):.2f}, max "
              f"{max(steps_ms):.2f}; CUDA events) against {np.median(pre):.2f} ms on the first "
              f"batch held on the card ({PRELOADED_STEPS} steps, min {min(pre):.2f}); host time "
              f"between steps (the loader's wait, batch_to_arrays, the copy to the card) median "
              f"{np.median(gaps_ms):.2f} ms, max {max(gaps_ms):.2f}; epoch {epoch_s:.2f} s for "
              f"{len(log) * CORPUS_BATCH} samples ({len(log) * CORPUS_BATCH / epoch_s:.1f} "
              f"samples/s trained); loader alone {loader_rate:.1f} samples/s at "
              f"{CORPUS_WORKERS} workers; {smi}")

        # resume: one more epoch, profiled; it starts after the newest epoch
        # written, best or not
        last = max(int(c.split("_")[1].split(".")[0]) for c in ckpts if c.startswith("model_"))
        held = {}

        def resume():
            held["test"], held["lines"] = run_train("train(max_epochs=3)", ds_cfg, root, base,
                                                    max_epochs=3, num_workers=CORPUS_WORKERS)

        with timed_run_steps() as log2:
            profile_call(resume, "train(max_epochs=3), one epoch resumed, profiled", smi,
                         (n_steps + 4) * CORPUS_BATCH * 3.0)
        epochs = {int(line.split()[1].rstrip(":")) for line in held["lines"]
                  if line.startswith("epoch ")}
        resumed = f"Resuming from epoch {last}" in held["lines"]
        print(f"resumed after the newest epoch written ({last}; 'Resuming from epoch {last}' "
              f"printed: {resumed}); epochs run {sorted(epochs)}, {len(log2)} steps, test "
              f"{held['test']:.4f}; train() launches K1 {k1.launches} and K2 {k2.launches} times")
        if not (resumed and last == 1 and epochs == {2}
                and len(log2) == n_steps and np.isfinite(held["test"])
                and os.path.isdir(os.path.join(base, "summaries", "epoch_2"))):
            fail("train(max_epochs=3) did not resume at epoch 2")
        if k1.launches or k2.launches:
            fail(f"train() launched K1 {k1.launches}, K2 {k2.launches} times")
        return k1.launches, k2.launches


# -- phase 11: evaluation ------------------------------------------------------------

# (noisy, clean) pairs of EVAL_SECONDS at 48 kHz under plain names, and
# EVAL_DNS_PAIRS more under DNS names; the metric pool's workers
EVAL_PAIRS, EVAL_DNS_PAIRS, EVAL_SECONDS, EVAL_WORKERS = 16, 4, 5.0, 4
EVAL_METRICS = ("stoi", "sisdr", "snrseg", "fwsnrseg", "llr", "wss", "pesq", "pesq-nb",
                "composite")
# card against CPU: each metric of a file within 1e-3 absolute, but the
# PESQ-based ones and WSS within bounds measured on the CPU: the largest move
# over these 16 pairs when white noise at 1e-4 of the enhanced audio's
# largest value (the bound the audio itself is held to) is added to it, six
# seeds, the demo checkpoint (`PYTHONPATH=. python tests/test_torch_eval.py`):
# 7.47e-4 (csig) and 3.11e-2 (WSS, whose spectral-slope weights step on small
# changes of the audio: 2.70e-3 already at 1e-6), rounded up
PESQ_KEYS = ("pesq_wb", "pesq_nb", "pesq", "csig", "cbak", "covl")
PESQ_TOL, WSS_TOL = 8e-4, 4e-2
# the hdf5_tool corpus: clip lengths in seconds (12 clips)
TOOL_CLIPS = (0.5, 1.0, 1.5, 2.0, 2.5, 3.0, 0.75, 1.25, 1.75, 2.25, 2.75, 3.25)


def write_eval_pairs(root):
    """Seeded pairs written with the port's save_audio: the clean side the
    script's harmonic-plus-noise speech, the noisy side that plus seeded white
    and babble-like noise (six other such voices, amplitude-modulated) at
    0-10 dB SNR. Returns {"noisy", "clean", "dns_noisy", "dns_clean": dir}."""
    from deepfilternet_torch.utils.audio_io import save_audio

    n = EVAL_PAIRS + EVAL_DNS_PAIRS
    clean = noisy_speech_like(n, EVAL_SECONDS, seed=300).astype(np.float64)
    rng = np.random.default_rng(301)
    t = np.arange(clean.shape[1]) / SR
    babble = sum(noisy_speech_like(n, EVAL_SECONDS, seed=310 + i)
                 * (1.0 + np.sin(2 * np.pi * rng.uniform(2.0, 5.0, (n, 1)) * t))
                 for i in range(6))
    white = rng.standard_normal(clean.shape)
    share = rng.uniform(0.0, 1.0, (n, 1))
    noise = share * white / white.std(1, keepdims=True) + (1 - share) * babble / babble.std(
        1, keepdims=True)
    snr = rng.uniform(0.0, 10.0, (n, 1))
    noisy = clean + noise * np.sqrt((clean ** 2).mean(1, keepdims=True)
                                    / ((noise ** 2).mean(1, keepdims=True) * 10 ** (snr / 10)))
    dirs = {k: os.path.join(root, k) for k in ("noisy", "clean", "dns_noisy", "dns_clean")}
    for d in dirs.values():
        os.makedirs(d)
    for i in range(n):
        if i < EVAL_PAIRS:
            save_audio(os.path.join(dirs["noisy"], f"pair_{i:02d}.wav"), noisy[i], SR)
            save_audio(os.path.join(dirs["clean"], f"pair_{i:02d}.wav"), clean[i], SR)
        else:
            k = 100 + i
            save_audio(os.path.join(dirs["dns_noisy"], f"synthetic_snr{int(snr[i, 0])}_fileid_{k}"
                                    ".wav"), noisy[i], SR)
            save_audio(os.path.join(dirs["dns_clean"], f"clean_fileid_{k}.wav"), clean[i], SR)
    # files --dns must not pair: no file id, a file id without its clean file
    save_audio(os.path.join(dirs["dns_noisy"], "no_id.wav"), noisy[0, :SR], SR)
    save_audio(os.path.join(dirs["dns_noisy"], "synthetic_fileid_9.wav"), noisy[0, :SR], SR)
    return dirs


@contextlib.contextmanager
def recorded_enhance():
    """The port's enhance(), each call's output and wall time recorded
    (evaluation_loop and test_df import it at each call). Its output is on
    the host, so the device's work is done when it returns."""
    from deepfilternet_torch import enhance as mod

    real, log = mod.enhance, []

    def record(*args, **kwargs):
        t0 = time.perf_counter()
        out = real(*args, **kwargs)
        log.append((out, time.perf_counter() - t0))
        return out

    mod.enhance = record
    try:
        yield log
    finally:
        mod.enhance = real


def quiet(fn, *args):
    """fn(*args) with its standard output captured; returns (its result or
    its SystemExit code, the lines it printed)."""
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            res = fn(*args)
        except SystemExit as e:
            res = e.code
    return res, out.getvalue().splitlines()


def read_csv(path):
    import csv

    with open(path, newline="") as f:
        return list(csv.reader(f))


def eval_dir_runs(smi, dirs, dev):
    """eval_dir.main over the plain pairs on `dev` and on the CPU, every
    metric, EVAL_WORKERS workers, a CSV each: means finite, 16 rows and every
    key; card against CPU the enhanced audio (1e-4 of its largest value) and
    each file's metrics. Returns the card run's {"wall", "enh", "enh_s"}."""
    from deepfilternet_torch.scripts import eval_dir

    args = ["-m", MODEL_DIR, "--noisy-dir", dirs["noisy"], "--clean-dir", dirs["clean"],
            "--metrics", ",".join(EVAL_METRICS), "--workers", str(EVAL_WORKERS)]
    runs = []
    for where in (dev, "cpu"):
        path = os.path.join(os.path.dirname(dirs["noisy"]), f"{where}.csv")
        with recorded_enhance() as log:
            t0 = time.perf_counter()
            means, _ = quiet(eval_dir.main, args + ["--csv", path, "--device", str(where)])
            wall = time.perf_counter() - t0
        rows = read_csv(path)
        runs.append({"means": means, "rows": rows, "wall": wall,
                     "enh": [o for o, _ in log], "enh_s": [s for _, s in log]})
        keys = sorted(means)
        ok = (len(keys) == 13 and all(np.isfinite(v) for v in means.values())
              and rows[0] == ["file"] + keys and len(rows) == EVAL_PAIRS + 1
              and all(len(r) == len(keys) + 1 and all(r) for r in rows[1:])
              and len(log) == EVAL_PAIRS)
        print(f"eval_dir on {where} ({EVAL_PAIRS} pairs x {EVAL_SECONDS} s, {EVAL_WORKERS} "
              f"workers): wall {wall:.1f} s; means "
              + ", ".join(f"{k} {means[k]:.4f}" for k in keys))
        if not ok:
            fail(f"eval_dir on {where}: means, CSV or enhance calls are wrong")
    card, cpu = runs
    audio_err = max(float(np.abs(a - b).max() / np.abs(b).max())
                    for a, b in zip(card["enh"], cpu["enh"]))
    keys = card["rows"][0][1:]
    worst = {k: max(abs(float(a[j]) - float(b[j])) for a, b in zip(card["rows"][1:],
                                                                    cpu["rows"][1:]))
             for j, k in enumerate(keys, 1)}
    tol = {k: PESQ_TOL if k in PESQ_KEYS else WSS_TOL if k == "wss" else 1e-3 for k in keys}
    bad = [k for k, v in worst.items() if v > tol[k]]
    print(f"eval_dir card against CPU on {smi}: enhanced audio {audio_err:.2e} of its largest "
          f"value (tol 1e-4); each file's metrics, largest difference: "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
          + f" (tol 1e-3; {', '.join(PESQ_KEYS)}: {PESQ_TOL}; wss: {WSS_TOL})")
    if audio_err > 1e-4 or bad:
        fail(f"eval_dir on the card disagrees with the CPU: audio {audio_err:.2e}, {bad}")
    return card


def eval_checks(smi, dirs, card):
    """--dns pairs exactly the DNS files; dnsmos raises; the metric pool's
    wall at 1 and EVAL_WORKERS workers on the card run's enhanced audio, and
    at EVAL_WORKERS with one OpenBLAS thread a worker (the spawned workers
    inherit the environment). Returns {label: metric wall in s}."""
    from deepfilternet_torch.enhance import DfState
    from deepfilternet_torch.eval.evaluation import compute_metrics, evaluation_loop
    from deepfilternet_torch.scripts import eval_dir

    dns = eval_dir.pair_files(dirs["dns_noisy"], dirs["dns_clean"], dns=True)
    want = sorted(os.path.join(dirs["dns_noisy"], f) for f in os.listdir(dirs["dns_noisy"])
                  if "snr" in f)
    means, lines = quiet(eval_dir.main, ["-m", MODEL_DIR, "--noisy-dir", dirs["dns_noisy"],
                                         "--clean-dir", dirs["dns_clean"], "--dns",
                                         "--metrics", "sisdr", "--workers", "1", "--device",
                                         "cpu"])
    try:
        compute_metrics(np.ones(SR, np.float32), np.ones(SR, np.float32), SR, ("dnsmos",))
        dnsmos = False
    except RuntimeError:
        dnsmos = True
    print(f"eval_dir --dns paired {len(dns)} files ({EVAL_DNS_PAIRS} DNS pairs, 2 decoys): "
          f"{[os.path.basename(n) for n, _ in dns]}, sisdr {means['sisdr']:.4f}; dnsmos raises "
          f"RuntimeError: {dnsmos}")
    if [n for n, _ in dns] != want or len(dns) != EVAL_DNS_PAIRS or not dnsmos:
        fail("eval_dir's DNS pairing or the dnsmos stub is wrong")
    pairs = eval_dir.pair_files(dirs["noisy"], dirs["clean"])
    walls = {}
    for label, workers, blas in (("1 worker", 1, None), (f"{EVAL_WORKERS}", EVAL_WORKERS, None),
                                 (f"{EVAL_WORKERS} with OPENBLAS_NUM_THREADS=1", EVAL_WORKERS,
                                  "1")):
        replay = iter(card["enh"])
        old = os.environ.get("OPENBLAS_NUM_THREADS")
        if blas is not None:
            os.environ["OPENBLAS_NUM_THREADS"] = blas
        try:
            t0 = time.perf_counter()
            means = evaluation_loop(None, DfState(), [n for n, _ in pairs],
                                    [c for _, c in pairs], metrics=EVAL_METRICS,
                                    n_workers=workers, enhance_fn=lambda audio: next(replay))
            walls[label] = time.perf_counter() - t0
        finally:
            if old is None:
                os.environ.pop("OPENBLAS_NUM_THREADS", None)
            else:
                os.environ["OPENBLAS_NUM_THREADS"] = old
        if not all(np.isfinite(v) for v in means.values()):
            fail(f"evaluation_loop at {label} gave a non-finite mean")
    return walls


def test_df_runs(smi, dirs, dev):
    """test_df on a copy of the demo directory: goldens written on the card,
    asserted on the card and on the CPU (each exits 0); each metric's CPU
    value against the card's golden."""
    import shutil

    from deepfilternet_torch.scripts import test_df

    with tempfile.TemporaryDirectory() as tmp:
        model = os.path.join(tmp, "model")
        shutil.copytree(MODEL_DIR, model)
        os.remove(os.path.join(model, "golden_metrics.json"))
        io_args = ["--noisy", os.path.join(dirs["noisy"], "pair_00.wav"),
                   "--clean", os.path.join(dirs["clean"], "pair_00.wav")]
        codes = [quiet(test_df.main, [model] + io_args + extra)[0]
                 for extra in (["--update-golden", "--device", str(dev)],
                               ["--device", str(dev)], ["--device", "cpu"])]
        with open(os.path.join(model, "golden_metrics.json")) as f:
            golden = json.load(f)
        got = test_df.eval_model(model, *io_args[1::2], device="cpu")
    diffs = {k: abs(got[k] - golden[k]) for k in got}
    print(f"test_df on a copy of {MODEL_DIR}: --update-golden on {dev}, then assert on {dev} "
          f"and on the CPU: exit codes {codes}; CPU against the card's goldens: "
          + ", ".join(f"{k} {v:.2e}" for k, v in diffs.items()) + f"; {smi}")
    if codes != [0, 0, 0] or set(got) != set(golden) - {"_pesq_scale"}:
        fail("test_df did not write and reproduce its goldens")


def libdf_compat_check(smi, dev):
    """libdf_compat on the card against the CPU: DF(48000, 960, 480) analysis
    and synthesis of 1 s, erb, erb_norm and unit_norm on that spectrum (1e-5;
    erb in dB plus two float32 ulps of the value), synthesis(analysis(x)) as
    x delayed by n_fft - hop (1e-4)."""
    from deepfilternet_torch import libdf_compat as ldf

    x = noisy_speech_like(2, 1.0, seed=320)
    dfs = {where: ldf.DF(SR, 960, HOP, device=where) for where in (dev, "cpu")}
    spec = {w: d.analysis(x) for w, d in dfs.items()}
    widths = dfs["cpu"].erb_widths()
    out = {w: d.synthesis(spec["cpu"]) for w, d in dfs.items()}
    erb = {w: ldf.erb(spec["cpu"], widths, device=w) for w in dfs}
    norm = {w: ldf.erb_norm(erb["cpu"], 0.99, device=w) for w in dfs}
    unit = {w: ldf.unit_norm(spec["cpu"][..., :96], 0.99, device=w) for w in dfs}
    errs = {name: float(np.abs(v[dev] - v["cpu"]).max())
            for name, v in (("analysis", spec), ("synthesis", out), ("erb_norm", norm),
                            ("unit_norm", unit))}
    erb_excess = float((np.abs(erb[dev] - erb["cpu"]) - 2.4e-7 * np.abs(erb["cpu"])).max())
    d = 960 - HOP
    delay = float(np.abs(dfs[dev].synthesis(spec[dev])[:, d:] - x[:, :-d]).max())
    types = (spec[dev].dtype == np.complex64 and spec[dev].shape == (2, SR // HOP, 481)
             and widths.dtype == np.uint64)
    print(f"libdf_compat on {smi} against the CPU: "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f" (tol 1e-5); erb beyond 2 ulps {erb_excess:.2e} (tol 1e-5); synthesis(analysis(x)) "
          f"against x delayed by {d}: {delay:.2e} (tol 1e-4); complex64 / uint64: {types}")
    if max(errs.values()) > 1e-5 or erb_excess > 1e-5 or delay > 1e-4 or not types:
        fail("libdf_compat on the card disagrees with the CPU")


def hdf5_tool_check(root):
    """hdf5_tool over a corpus the port's prepare_data writes (12 clips):
    list; sample (the wav holds Hdf5Dataset.read's clip as save_audio scales
    it); split 0.8,0.1,0.1 (the key sets partition the corpus, every key bit
    for bit with its attributes); trim; fix of a copy whose n_samples were
    written wrong."""
    from deepfilternet_torch.data.h5file import H5File, H5Writer
    from deepfilternet_torch.data.hdf5 import Hdf5Dataset
    from deepfilternet_torch.scripts import hdf5_tool
    from deepfilternet_torch.scripts.prepare_data import prepare
    from deepfilternet_torch.utils.audio_io import load_audio, save_audio

    paths = []
    for i, seconds in enumerate(TOOL_CLIPS):
        paths.append(os.path.join(root, f"tool_{i:02d}.wav"))
        save_audio(paths[-1], noisy_speech_like(1, seconds, seed=330 + i)[0], SR)
    corpus = os.path.join(root, "tool.hdf5")
    quiet(prepare, "speech", corpus, paths)
    with H5File(corpus) as f:
        src = {k: (f["speech"][k][...], dict(f["speech"][k].attrs)) for k in f["speech"].keys()}

    def same(f, k):
        data, attrs = src[k]
        d = f["speech"][k]
        return (d.dtype == data.dtype and np.array_equal(d[...], data)
                and {a: np.asarray(v).tolist() for a, v in d.attrs.items()}
                == {a: np.asarray(v).tolist() for a, v in attrs.items()})

    _, listed = quiet(hdf5_tool.main, ["list", corpus, "--max-keys", "12"])
    key = sorted(src)[3]
    wav = os.path.join(root, "sample.wav")
    quiet(hdf5_tool.main, ["sample", corpus, wav, "--key", key])
    ds = Hdf5Dataset(corpus)
    clip = ds.read("speech", key)
    ds.close()
    got, _ = load_audio(wav)
    sample_ok = np.array_equal(np.round(got * 32768), np.round(np.clip(clip, -1, 1) * 32767.0))
    os.makedirs(os.path.join(root, "split"))
    quiet(hdf5_tool.main, ["split", corpus, os.path.join(root, "split"), "--ratios", "0.8,0.1,0.1"])
    parts, split_ok = [], True
    for part in ("train", "valid", "test"):
        with H5File(os.path.join(root, "split", f"tool_{part}.hdf5")) as f:
            parts.append(f["speech"].keys())
            split_ok &= all(same(f, k) for k in parts[-1])
    keys = [k for p in parts for k in p]
    split_ok &= sorted(keys) == sorted(src) and [len(p) for p in parts] == [9, 1, 2]
    trimmed = os.path.join(root, "trim.hdf5")
    _, trim_lines = quiet(hdf5_tool.main, ["trim", corpus, trimmed, "--max-len-s", "2"])
    with H5File(trimmed) as f:
        kept = f["speech"].keys()
        trim_ok = (sorted(kept) == sorted(k for k in src if src[k][0].shape[-1] <= 2 * SR)
                   and all(same(f, k) for k in kept))
    broken = os.path.join(root, "broken.hdf5")
    with H5Writer(broken) as w, H5File(corpus) as f:
        for name, value in f.attrs.items():
            w.set_attr("/", name, value)
        for i, (k, (data, attrs)) in enumerate(sorted(src.items())):
            w.create_dataset(f"speech/{k}", data, attrs=dict(
                attrs, n_ch=1, **({"n_samples": np.array([7])} if i % 2 else {})))
    _, fix_lines = quiet(hdf5_tool.main, ["fix", broken])
    with H5File(broken) as f:
        fix_ok = all(int(f["speech"][k].attrs["n_samples"]) == src[k][0].shape[-1]
                     and int(f["speech"][k].attrs["n_channels"]) == 1
                     and "n_ch" not in f["speech"][k].attrs
                     and np.array_equal(f["speech"][k][...], src[k][0]) for k in src)
    print(f"hdf5_tool on a {len(src)}-clip corpus from prepare_data: list '{listed[1].strip()}'; "
          f"sample {key} as save_audio scales Hdf5Dataset.read's clip: {sample_ok}; split "
          f"{[len(p) for p in parts]}, a partition, bit for bit: {split_ok}; trim "
          f"'{trim_lines[-1]}', bit for bit: {trim_ok}; fix '{fix_lines[-1]}', n_samples and "
          f"n_channels right, n_ch gone: {fix_ok}")
    if not (listed[1].strip().startswith("[speech] 12 keys") and sample_ok and split_ok
            and trim_ok and fix_ok):
        fail("hdf5_tool's commands are wrong")


def evaluation_path(card, smi, dev="cuda"):
    """Phase 11. Returns the launches of K1 and K2 over it."""
    from deepfilternet_torch.checkpoint import read_cp
    from deepfilternet_torch.enhance import init_df
    from deepfilternet_torch.ops.fused_frontend import fused_analysis_frontend as k1
    from deepfilternet_torch.ops.whole_cell import cell_process as k2
    from deepfilternet_torch.utils.logger import count_params, model_summary

    t_phase = time.perf_counter()
    k1.launches = k2.launches = 0
    with tempfile.TemporaryDirectory() as root:
        dirs = write_eval_pairs(root)
        run = eval_dir_runs(smi, dirs, dev)
        walls = eval_checks(smi, dirs, run)
        test_df_runs(smi, dirs, dev)
        libdf_compat_check(smi, dev)
        hdf5_tool_check(root)
    model, _, _ = init_df(MODEL_DIR, device=dev)
    n_ckpt = sum(np.asarray(v).size for _, v in
                 named_leaves(read_cp(os.path.join(MODEL_DIR, "checkpoints"), "best")["params"]))
    print(f"{model_summary(model.params, model.cfg)}; count_params {count_params(model.params)}, "
          f"the checkpoint's leaves {n_ckpt}")
    if count_params(model.params) != n_ckpt:
        fail("count_params disagrees with the checkpoint")
    phase = time.perf_counter() - t_phase
    enh = run["enh_s"]
    scored = EVAL_PAIRS * EVAL_SECONDS
    print(f"evaluation timings on {smi}: enhance a file ({EVAL_SECONDS} s) median "
          f"{np.median(enh) * 1e3:.1f} ms (first {enh[0] * 1e3:.1f}, max {max(enh) * 1e3:.1f}); "
          f"metric pool over {EVAL_PAIRS} files "
          + ", ".join(f"{v:.2f} s at {k}" for k, v in walls.items()) + "; eval_dir on the card "
          f"{scored / run['wall']:.1f} audio seconds scored a wall second, the host's metrics "
          f"(wall less enhance) {1 - sum(enh) / run['wall']:.1%} of its {run['wall']:.1f} s; "
          f"phase {phase:.1f} s, metric passes {sum(walls.values()) / phase:.1%} of it; "
          f"K1 launches {k1.launches}, K2 {k2.launches}")
    if k1.launches or k2.launches:
        fail(f"evaluation launched K1 {k1.launches}, K2 {k2.launches} times")
    return k1.launches, k2.launches


# -- phase 12: DFN2/DFN1 at bfloat16, the export, the demo trainers -----------------

DEMO_CORPUS = {"clean": (1, 3.0), "noise_flac": (4, 3.0)}  # clips, seconds
DEMO_BUDGET_S, DEMO_RESUME_S, TRIAL_BUDGET_S = 4.0, 1.0, 2.0


def family_bf16(card, smi, model_dir, audio):
    """A DFN2 or DFN1 checkpoint at bfloat16 on the card: StreamingRuntime(
    dtype=bfloat16) on the main path's 64 x 2 s (K1 once a frame, counted, and
    held against its plain version on the first frame) against the same 4
    streams in bfloat16 on the CPU (0.05) and the card's float32 run
    (BF16_DRIFT_TOL), its carry's types; ChunkedStreamingRuntime(dtype=
    bfloat16) against it (BF16_DRIFT_TOL, no K1); out_dtype=bfloat16 once.
    Returns (family, K1's launches)."""
    from deepfilternet_torch.enhance import init_df
    from deepfilternet_torch.ops.fused_frontend import fused_analysis_frontend as k1
    from deepfilternet_torch.ops.whole_cell import cell_process as k2
    from deepfilternet_torch.streaming import ChunkedStreamingRuntime, StreamingRuntime

    bf16 = torch.bfloat16
    model, df_state, suffix = init_df(model_dir)
    cpu_model, cpu_state, _ = init_df(model_dir, device="cpu")
    fam = {"dfnet2": "DFN2", "dfnet1": "DFN1"}[model.module.__name__.rsplit(".", 1)[1]]
    tag = f"{fam} ({model_dir}, {suffix}) bfloat16"
    s, n_frames = audio.shape[0], audio.shape[1] // HOP
    rt32 = StreamingRuntime(model, df_state)
    f32 = rt32.process(rt32.init(s), audio)[1].cpu().numpy()

    rt = StreamingRuntime(model, df_state, dtype=bf16)
    k1_ratio = k1_first_frame(rt, audio)
    rt.process(rt.init(s), audio[:, : 5 * HOP])  # warm-up
    torch.cuda.synchronize()
    k1.launches = k2.launches = 0
    t0 = time.perf_counter()
    carry, out_dev = rt.process(rt.init(s), audio)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = k1.launches
    if launches != n_frames or k2.launches:
        fail(f"{tag} per frame: K1 launches {launches} (want {n_frames}), K2 {k2.launches}")
    out = out_dev.cpu().numpy()
    if out.shape != audio.shape or out_dev.dtype != torch.float32 or not np.isfinite(out).all():
        fail(f"{tag} per-frame output {out.shape} {out_dev.dtype} malformed")
    kinds = {f: getattr(carry.model, f).dtype for f in carry.model._fields}
    want = {f: torch.float32 if "ring" in f else bf16 for f in kinds}
    if kinds != want:
        fail(f"{tag} carry types {kinds}")
    cpu_rt = StreamingRuntime(cpu_model, cpu_state, dtype=bf16)
    ref = cpu_rt.process(cpu_rt.init(4), audio[:4])[1].numpy()
    e_cpu, e_f32 = scale_err(out[:4], ref), scale_err(out, f32)
    if not (e_cpu <= 0.05 and e_f32 <= BF16_DRIFT_TOL):
        fail(f"{tag} per frame: vs the CPU {e_cpu:.3e} (tol 0.05), vs float32 {e_f32:.3e} "
             f"(tol {BF16_DRIFT_TOL}) of the largest value")
    print(f"{tag} StreamingRuntime(dtype=bfloat16).process S={s} x {SECONDS} s = {n_frames} "
          f"frames on {smi}: K1 launches {launches}, {wall:.3f} s wall "
          f"({wall / n_frames * 1e3:.2f} ms a frame), aggregate RTF {SECONDS * s / wall:.1f}x "
          f"(information only); vs the same 4 streams in bfloat16 on the CPU {e_cpu:.3e} of the "
          f"largest value (tol 0.05), vs the card's float32 run {e_f32:.3e} (tol "
          f"{BF16_DRIFT_TOL}); carry {sum(t == bf16 for t in kinds.values())} bfloat16 leaves, "
          f"{sum(t == torch.float32 for t in kinds.values())} float32; K1 against its plain "
          f"version on the first frame {k1_ratio:.3f} x its tolerance")
    profile_frames(rt, audio[:, : 20 * HOP], smi, label=f"{fam} per-frame")

    crt = ChunkedStreamingRuntime(model, df_state, dtype=bf16)
    crt.process(crt.init(s), audio[:, : 20 * HOP])  # warm-up
    torch.cuda.synchronize()
    k1.launches = k2.launches = 0
    t0 = time.perf_counter()
    c_out = crt.process(crt.init(s), audio)[1].cpu().numpy()
    c_wall = time.perf_counter() - t0
    e_pf = scale_err(c_out, out)
    if k1.launches or k2.launches or not (np.isfinite(c_out).all() and e_pf <= BF16_DRIFT_TOL):
        fail(f"{tag} chunked: K1 {k1.launches}, K2 {k2.launches} launches, vs per frame "
             f"{e_pf:.3e} (tol {BF16_DRIFT_TOL})")
    print(f"{tag} ChunkedStreamingRuntime(dtype=bfloat16) S={s} x {SECONDS} s in chunks of "
          f"{crt.chunk_frames}: {c_wall:.3f} s wall (information only); vs the per-frame "
          f"bfloat16 run {e_pf:.3e} of the largest value (tol {BF16_DRIFT_TOL}); K1 and K2 "
          "launches 0")

    short = audio[:, : 20 * HOP]
    o_rt = StreamingRuntime(model, df_state, dtype=bf16, out_dtype=bf16)
    o_b = o_rt.process(o_rt.init(s), short)[1]
    o_f = rt.process(rt.init(s), short)[1]
    if o_b.dtype != bf16 or not torch.equal(o_b, o_f.to(bf16)):
        fail(f"{tag}: out_dtype=bfloat16 is not the bfloat16 model's output cast")
    print(f"{tag} StreamingRuntime(dtype=out_dtype=bfloat16): the output cast, bit for bit, "
          "20 frames")
    return fam, launches


def export_path(card, smi, root):
    """export_model of the DFN3 and DFN2 checkpoints on the card; both
    programs of each archive played on the card on seeded features against
    the eager forward and streaming cell on the card (1e-5 of the largest
    value); init_df(archive) and enhance() on [1, 2 s] against init_df(dir).
    Returns the K1 and K2 launches over the exports."""
    from deepfilternet_torch.config import config
    from deepfilternet_torch.enhance import enhance, init_df
    from deepfilternet_torch.ops.fused_frontend import fused_analysis_frontend as k1
    from deepfilternet_torch.ops.whole_cell import cell_process as k2
    from deepfilternet_torch.scripts.export import export_model, load_exported

    k1.launches = k2.launches = 0
    x1 = noisy_speech_like(1, SECONDS, seed=12)
    for model_dir in (MODEL_DIR, FAMILIES[0]):
        path = os.path.join(root, os.path.basename(model_dir) + ".tar.gz")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(open(os.devnull, "w")):
            export_model(model_dir, path)
        wall = time.perf_counter() - t0
        model, df_state, _ = init_df(model_dir)
        cfg = model.cfg
        rng = np.random.default_rng(12)
        x = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda()
             for shape in ((1, 10, cfg["freq_bins"], 2), (1, 10, cfg["nb_erb"]),
                           (1, 10, cfg["nb_df"], 2))]
        off = load_exported(path, "offline.pt2")
        cell = load_exported(path, "streaming_cell.pt2")
        with torch.no_grad():
            got = off(*x)
            (spec_e, m, lsnr, _), _ = model.module.forward(model.params, model.state, cfg, *x)
            e_off = max(scale_err(a.cpu().numpy(), b.cpu().numpy())
                        for a, b in zip(got, (spec_e, m, lsnr)))
            carry = ref_carry = model.module.streaming_init(1, cfg, device=model.device)
            e_cell = 0.0
            for i in range(3):
                frame = [a[:, i] for a in x]
                carry, o = cell(carry, *frame)
                ref_carry, r = model.module.streaming_cell(model.params, model.state, cfg,
                                                           ref_carry, *frame)
                e_cell = max([e_cell] + [scale_err(a.cpu().numpy(), b.cpu().numpy())
                                         for a, b in zip(list(carry) + list(o),
                                                         list(ref_carry) + list(r))
                                         if b.numel()])
        a_model, a_state, a_suffix = init_df(path)
        same = enhance(a_model, a_state, x1)
        direct = enhance(model, df_state, x1)
        e_arc = scale_err(same, direct)
        config.reset()
        if not (e_off <= 1e-5 and e_cell <= 1e-5 and e_arc <= 1e-6
                and a_model.device.type == "cuda"):
            fail(f"export of {model_dir}: offline program {e_off:.3e}, cell {e_cell:.3e} "
                 f"(tol 1e-5), enhance from the archive {e_arc:.3e} (tol 1e-6)")
        print(f"export_model({model_dir}) on {smi}: {wall:.2f} s wall, archive "
              f"{os.path.getsize(path) / 2**20:.1f} MiB; offline.pt2 [1, 10 frames] against the "
              f"eager forward on the card {e_off:.3e}, streaming_cell.pt2 over 3 frames against "
              f"the eager cell {e_cell:.3e} of the largest value (tol 1e-5); init_df(archive) "
              f"({a_suffix}) enhance() [1, {SECONDS} s] against init_df(dir) {e_arc:.3e} "
              "(tol 1e-6)")
    return k1.launches, k2.launches


def write_demo_corpus(root, corpus=DEMO_CORPUS):
    """The demo trainers' corpus: clean.hdf5 and noise_flac.hdf5 of
    `corpus` {name: (clips, seconds)}, seeded WAVs written by the port's
    prepare_data."""
    from deepfilternet_torch.scripts.prepare_data import prepare
    from deepfilternet_torch.utils.audio_io import save_audio

    rng = np.random.default_rng(300)
    for name, (n, seconds) in corpus.items():
        if name == "clean":
            clips = noisy_speech_like(n, seconds, seed=301) * 0.5
        else:
            t = np.arange(int(seconds * SR)) / SR
            clips = (rng.standard_normal((n, t.size)) * rng.uniform(0.02, 0.2, (n, 1))
                     * (1.0 + 0.5 * np.sin(2 * np.pi * rng.uniform(0.1, 2.0, (n, 1)) * t)))
        paths = []
        for i, x in enumerate(clips):
            paths.append(os.path.join(root, f"{name}_{i}.wav"))
            save_audio(paths[-1], x, SR)
        with contextlib.redirect_stdout(open(os.devnull, "w")):
            prepare("speech" if name == "clean" else "noise",
                    os.path.join(root, f"{name}.hdf5"), paths)


def captured(fn, *args, **kwargs):
    """fn's standard output as a string (fn's own result dropped)."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args, **kwargs)
    return buf.getvalue()


def demo_training_path(card, smi, root, audio):
    """train_demo on a copy of the DFN3 demo checkpoint over a seeded corpus
    (DEMO_POOLS=2): the loss falls, a best checkpoint is written and a second
    call resumes from it; the trained model through StreamingRuntime on the
    main path's 64 x 2 s (K1 once a frame); overfit_trial writes its
    checkpoint and SI-SDR line. Returns (K1 and K2 launches over the two
    trainers, K1's launches on the trained model's per-frame run)."""
    import re
    import shutil

    from deepfilternet_torch.checkpoint import read_cp
    from deepfilternet_torch.config import config
    from deepfilternet_torch.enhance import init_df
    from deepfilternet_torch.ops.fused_frontend import fused_analysis_frontend as k1
    from deepfilternet_torch.ops.whole_cell import cell_process as k2
    from deepfilternet_torch.scripts import overfit_trial, train_demo
    from deepfilternet_torch.streaming import StreamingRuntime

    assets = os.path.join(root, "assets")
    os.makedirs(assets)
    write_demo_corpus(assets)
    demo = os.path.join(root, "demo")
    shutil.copytree(MODEL_DIR, demo)
    old_env = {k: os.environ.get(k) for k in ("DEMO_ASSETS", "DEMO_POOLS")}
    os.environ.update(DEMO_ASSETS=assets, DEMO_POOLS="2")
    k1.launches = k2.launches = 0
    try:
        t0 = time.perf_counter()
        first = captured(train_demo.main, demo, budget_s=DEMO_BUDGET_S)
        wall = time.perf_counter() - t0
        ckpts = sorted(os.listdir(os.path.join(demo, "checkpoints")))
        second = captured(train_demo.main, demo, budget_s=DEMO_RESUME_S)
    finally:
        for k, v in old_env.items():
            os.environ.pop(k) if v is None else os.environ.__setitem__(k, v)
    pattern = r"steps (\d+)->(\d+) \(kept (\d+)\), loss ([\d.]+) -> ([\d.]+|inf), ([\d.]+) steps/s"
    steps, resumed = re.search(pattern, first), re.search(pattern, second)
    sisdr = re.search(r"train-set si_sdr .*", first)
    if not (steps and resumed and sisdr):
        fail(f"train_demo printed no steps or SI-SDR line:\n{first}\n{second}")
    s0, n, kept, l0, best, rate = (float(v) for v in steps.groups())
    ok = (n - s0 >= 20 and best < l0 and kept > s0
          and f"model_{int(kept)}.ckpt.best" in ckpts
          and f"resumed from step {int(kept)}" in second and "restarting" not in second)
    print(f"train_demo on a copy of {MODEL_DIR} over a {DEMO_CORPUS} corpus (DEMO_POOLS=2, "
          f"batch 8 x 3 s) on {smi}: steps {int(s0)}->{int(n)} in {DEMO_BUDGET_S} s of budget "
          f"({wall:.1f} s wall with the pool), {rate:.2f} steps/s, loss (first 3) {l0:.4f} -> "
          f"best window {best:.4f} (falls: {best < l0}), kept step {int(kept)}; checkpoints "
          f"{ckpts}; {sisdr.group(0)}; the second call resumed from step {int(kept)}: "
          f"{f'resumed from step {int(kept)}' in second}")
    if not ok:
        fail(f"train_demo: the loss did not fall, no best checkpoint or no resume:\n{first}\n"
             f"{second}")

    trial = os.path.join(root, "trial")
    t0 = time.perf_counter()
    out = captured(overfit_trial.main, budget_s=TRIAL_BUDGET_S, ckpt_dir=trial,
                   assets_dir=assets)
    wall = time.perf_counter() - t0
    t_steps = re.search(r"steps (\d+)->(\d+), loss ([\d.]+) -> ([\d.]+), ([\d.]+) steps/s", out)
    t_sisdr = re.search(r"si_sdr noisy=.*", out)
    payload = read_cp(trial)
    if not (t_steps and t_sisdr and payload and "opt_state" in payload
            and payload["epoch"] == int(t_steps.group(2))):
        fail(f"overfit_trial: no checkpoint with its optimizer state, or no SI-SDR line:\n{out}")
    print(f"overfit_trial (DFN3 init_model seed 0, batch 8 x 3 s) on {smi}: steps "
          f"{t_steps.group(1)}->{t_steps.group(2)} in {TRIAL_BUDGET_S} s of budget ({wall:.1f} s "
          f"wall), {t_steps.group(5)} steps/s, loss {t_steps.group(3)} -> {t_steps.group(4)}; "
          f"{t_sisdr.group(0)}; checkpoint epoch {payload['epoch']} with its optimizer state")
    trainer_k1, trainer_k2 = k1.launches, k2.launches

    model, df_state, suffix = init_df(demo)
    config.reset()
    rt = StreamingRuntime(model, df_state)
    s, n_frames = audio.shape
    n_frames //= HOP
    k1.launches = 0
    o = rt.process(rt.init(s), audio)[1].cpu().numpy()
    trained = k1.launches
    if trained != n_frames or not np.isfinite(o).all() or suffix != f"e{resumed.group(3)}":
        fail(f"the demo-trained model ({suffix}) through StreamingRuntime: K1 {trained} "
             f"(want {n_frames}), finite {np.isfinite(o).all()}")
    print(f"the demo-trained model (init_df, {suffix}) through StreamingRuntime S={s} x "
          f"{SECONDS} s: K1 launches {trained} in {n_frames} frames, finite output")
    return trainer_k1, trainer_k2, trained


def families_bf16_export_demo_path(card, smi, audio):
    """Phase 12. The ASR loss (train/asr_loss.py) is not driven here: the
    card's machine has no transformers, and so no torch Whisper. Returns the
    kernels line's entries: {"K1": {...}, "K2": {...}}."""
    k1e, k2e = {}, {}
    t0 = time.perf_counter()
    for model_dir in FAMILIES:
        fam, launches = family_bf16(card, smi, model_dir, audio)
        k1e[f"{fam.lower()}_bf16_launches"] = launches
    t_bf16 = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        k1e["export_launches"], k2e["export_launches"] = export_path(card, smi, root)
        t_export = time.perf_counter() - t0
        t0 = time.perf_counter()
        (k1e["demo_training_launches"], k2e["demo_training_launches"],
         k1e["demo_trained_launches"]) = demo_training_path(card, smi, root, audio)
        t_demo = time.perf_counter() - t0
    print(f"phase 12 parts on {smi}: DFN2/DFN1 bfloat16 {t_bf16:.1f} s, export "
          f"{t_export:.1f} s, demo trainers {t_demo:.1f} s; K1 launches over the exports "
          f"{k1e['export_launches']}, over the trainers {k1e['demo_training_launches']}; K2 "
          f"{k2e['export_launches']}, {k2e['demo_training_launches']}")
    if (k1e["export_launches"] or k2e["export_launches"] or k1e["demo_training_launches"]
            or k2e["demo_training_launches"]):
        fail("the export or the demo trainers launched a kernel")
    return {"K1": k1e, "K2": k2e}


# -- phase 13: a corpus in the newer HDF5 formats ------------------------------------

# the corpus h5py wrote with libver="latest" (tests/test_torch_h5file_latest.py
# ::write_latest_corpus): superblock 3, version-2 object headers, dense links
# and attributes (fractal heaps, v2 B-trees), fixed-array chunk indexes, a
# noise group in creation order
LATEST_DIR = os.path.join("deepfilternet_torch", "data", "testdata")
LATEST_FILES = ("speech.hdf5", "noise.hdf5", "rir.hdf5")
# the demo's config.ini with these keys and the loss stack of phase 9: one
# epoch (epoch 1 after the checkpoint as epoch 0) of [8, 1 s] batches over
# the 16 speech clips
LATEST_TRAIN = (("train", "MAX_EPOCHS", "2"), ("train", "BATCH_SIZE", "8"),
                ("train", "MAX_SAMPLE_LEN_S", "1"), ("distortion", "p_reverb", "0.2"))
LATEST_WORKERS, LATEST_BATCH, LATEST_ROUNDS = 1, 8, 3
LATEST_PHASE_S = 60.0


def read_all(path):
    """{group/key: the int16 array} of every dataset of a corpus file,
    through H5File."""
    from deepfilternet_torch.data.h5file import H5File

    with H5File(path) as f:
        return {f"{g}/{k}": f[g][k][...] for g in f["/"].keys() for k in f[g].keys()}


def latest_read_check(root, manifest):
    """Every key of the committed files through H5File (shape and sha256 of
    the int16 bytes as the manifest gives them) and through Hdf5Dataset
    (the same samples as float); the groups' keys in h5py's order, the noise
    group's in creation order. Returns the int16 bytes read."""
    import hashlib

    from deepfilternet_torch.data.h5file import H5File
    from deepfilternet_torch.data.hdf5 import Hdf5Dataset

    nbytes = 0
    for name, groups in manifest.items():
        path = os.path.join(root, name)
        ds = Hdf5Dataset(path)
        with H5File(path) as f:
            for g, entry in groups.items():
                if f[g].keys() != entry["order"]:
                    fail(f"{name}: {g}'s keys {f[g].keys()} are not h5py's {entry['order']}")
                for k, want in entry["keys"].items():
                    data = f[g][k][...]
                    if (list(data.shape) != want["shape"] or data.dtype != np.int16
                            or hashlib.sha256(data.tobytes()).hexdigest() != want["sha256"]
                            or not np.array_equal(ds.read(g, k), data.astype(np.float32) / 32768)):
                        fail(f"{name}: {g}/{k} does not read back as its manifest says")
                    nbytes += data.nbytes
        ds.close()
    order = manifest["noise.hdf5"]["noise"]["order"]
    print(f"latest-format corpus ({LATEST_DIR}: superblock 3, dense links and attributes, "
          f"fixed-array chunk indexes) through H5File and Hdf5Dataset: "
          + ", ".join(f"{n} {sum(len(e['keys']) for e in g.values())} keys"
                      for n, g in manifest.items())
          + f", {nbytes / 1e6:.2f} MB of int16 samples, every key's sha256 as the manifest's; "
          f"noise in creation order {order[:4]}... (by name {sorted(order)[:4]}...)")
    return nbytes


def latest_copies(root, copies, nbytes):
    """Each file copied into h5py's default format by the port's H5Writer
    (copy_group) and both read back equal; the read rate of each format (MB
    of int16 samples a second through H5File, best of LATEST_ROUNDS rounds
    in turns) as information."""
    from deepfilternet_torch.data.h5file import H5File, H5Writer, copy_group

    os.makedirs(copies)
    for name in LATEST_FILES:
        with H5File(os.path.join(root, name)) as src, \
                H5Writer(os.path.join(copies, name)) as dst:
            copy_group(src["/"], dst)
        a, b = read_all(os.path.join(root, name)), read_all(os.path.join(copies, name))
        with H5File(os.path.join(root, name)) as f, H5File(os.path.join(copies, name)) as g:
            attrs_same = ({k: np.asarray(v).tolist() for k, v in f.attrs.items()}
                          == {k: np.asarray(v).tolist() for k, v in g.attrs.items()})
        if not (attrs_same and a.keys() == b.keys()
                and all(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)):
            fail(f"{name}: the default-format copy does not read back as the latest-format file")
        with open(os.path.join(copies, name), "rb") as f:
            if f.read(9)[8] != 0:
                fail(f"{name}: the copy is not in h5py's default format (superblock 0)")
    best = {"latest": float("inf"), "default": float("inf")}
    for _ in range(LATEST_ROUNDS):
        for tag, d in (("latest", root), ("default", copies), ("default", copies),
                       ("latest", root)):
            t0 = time.perf_counter()
            for name in LATEST_FILES:
                read_all(os.path.join(d, name))
            best[tag] = min(best[tag], time.perf_counter() - t0)
    rates = {k: nbytes / v / 1e6 for k, v in best.items()}
    print(f"the corpus copied into h5py's default format (superblock 0, symbol tables, v1 "
          f"B-trees; the chunks byte for byte, in h5py's chunks of 3,163-5,867 samples) by "
          f"H5Writer / "
          f"copy_group: every key, dtype and attribute equal; a whole "
          f"read through H5File (host, {os.cpu_count()} cores), best of {LATEST_ROUNDS} in "
          f"turns: latest format {rates['latest']:.1f} MB/s of int16 samples, default format "
          f"{rates['default']:.1f} MB/s")
    return rates


def latest_tool_check(root, manifest):
    """hdf5_tool list, split and trim over the latest-format speech file:
    the key count listed; the splits a partition of the keys, each bit for
    bit; trim keeps the clips no longer than its bound, bit for bit."""
    from deepfilternet_torch.data.h5file import H5File
    from deepfilternet_torch.scripts import hdf5_tool

    src = os.path.join(root, "speech.hdf5")
    whole = read_all(src)
    n = len(manifest["speech.hdf5"]["speech"]["keys"])
    _, listed = quiet(hdf5_tool.main, ["list", src, "--max-keys", "3"])
    out = os.path.join(root, "split")
    os.makedirs(out)
    quiet(hdf5_tool.main, ["split", src, out, "--ratios", "0.75,0.125,0.125"])
    parts = [read_all(os.path.join(out, f"speech_{p}.hdf5")) for p in ("train", "valid", "test")]
    keys = [k for p in parts for k in p]
    split_ok = (sorted(keys) == sorted(whole) and [len(p) for p in parts] == [12, 2, 2]
                and all(np.array_equal(v, whole[k]) for p in parts for k, v in p.items()))
    trimmed = os.path.join(root, "trim.hdf5")
    _, trim_lines = quiet(hdf5_tool.main, ["trim", src, trimmed, "--max-len-s", "0.75"])
    kept = read_all(trimmed)
    trim_ok = (sorted(kept) == sorted(k for k, v in whole.items() if v.shape[-1] <= 0.75 * SR)
               and 0 < len(kept) < n and all(np.array_equal(v, whole[k]) for k, v in kept.items()))
    with H5File(trimmed) as f, H5File(src) as g:
        trim_ok &= ({k: np.asarray(v).tolist() for k, v in f.attrs.items()}
                    == {k: np.asarray(v).tolist() for k, v in g.attrs.items()})
    print(f"hdf5_tool on the latest-format speech file: list '{listed[1].strip()}'; split "
          f"{[len(p) for p in parts]}, a partition, bit for bit: {split_ok}; trim "
          f"'{trim_lines[-1]}', bit for bit: {trim_ok}")
    if not (listed[1].strip().startswith(f"[speech] {n} keys") and split_ok and trim_ok):
        fail("hdf5_tool over the latest-format corpus is wrong")


def latest_merge_check(root):
    """prepare_data merges two new seeded WAVs into a copy of the
    latest-format speech file in `root`, in place: every old key as
    MANIFEST.json says, the new ones as prepare_data stores them, the keys
    by name as h5py iterates them, and still superblock 3."""
    import hashlib
    import shutil

    from deepfilternet_torch.data.h5file import H5File
    from deepfilternet_torch.scripts.prepare_data import prepare, sanitize_key
    from deepfilternet_torch.utils.audio_io import load_audio, save_audio

    with open(os.path.join(LATEST_DIR, "MANIFEST.json")) as f:
        manifest = json.load(f)["speech.hdf5"]["speech"]["keys"]
    merged = os.path.join(root, "merged.hdf5")
    shutil.copy(os.path.join(root, "speech.hdf5"), merged)
    wavs = []
    for i in range(2):
        wavs.append(os.path.join(root, f"merge_{i}.wav"))
        save_audio(wavs[-1], noisy_speech_like(1, 0.6, seed=1300 + i)[0], SR)
    quiet(prepare, "speech", merged, wavs)
    got = read_all(merged)
    new = {}
    for p in wavs:
        audio, _ = load_audio(p)
        new[f"speech/{sanitize_key(p)}"] = np.clip(audio * 32767.0, -32768, 32767).astype(np.int16)
    with H5File(merged) as f:
        version, keys = f.superblock_version, f["speech"].keys()
    ok = (version == 3 and keys == sorted(keys)
          and got.keys() == {f"speech/{k}" for k in manifest} | new.keys()
          and all(list(got[f"speech/{k}"].shape) == w["shape"] and hashlib.sha256(
              got[f"speech/{k}"].tobytes()).hexdigest() == w["sha256"]
              for k, w in manifest.items())
          and all(np.array_equal(got[k], v) for k, v in new.items()))
    print(f"prepare_data merged 2 seeded WAVs into a copy of the latest-format speech file in "
          f"place: {len(got)} keys, the {len(manifest)} old as MANIFEST.json says and 2 new bit "
          f"for bit, keys by name, superblock still {version}: {ok}")
    if not ok:
        fail("prepare_data's merge into the latest-format corpus is wrong")


def latest_dataset_cfg(d):
    files = [[n, 1] for n in LATEST_FILES]
    with open(os.path.join(d, "dataset.cfg"), "w") as f:
        json.dump({"train": files, "valid": files, "test": files}, f)
    return os.path.join(d, "dataset.cfg")


def latest_loader_check(root, copies, nb_erb, nb_df):
    """One epoch of DataLoader(FdDataset(TdDataset)) at LATEST_WORKERS over
    the latest-format files and over their default-format copies, in turns
    (latest, default, default, latest): every epoch's batches bit for bit
    equal. Returns the first batch."""
    from deepfilternet_torch.data.dataloader import DataLoader
    from deepfilternet_torch.data.dataset import DatasetConfig, FdDataset, TdDataset

    runs = []
    for tag, d in (("latest", root), ("default", copies), ("default", copies),
                   ("latest", root)):
        cfgs = DatasetConfig.open(latest_dataset_cfg(d)).split("train")
        td = TdDataset(d, cfgs, "train", sr=SR, max_len_s=1.0, p_reverb=0.2, seed=42)
        loader = DataLoader(FdDataset(td, 960, HOP, nb_erb, nb_df), LATEST_BATCH,
                            num_workers=LATEST_WORKERS, drop_last=True)
        t0 = time.perf_counter()
        runs.append((tag, list(loader.iter_epoch("train", 0)), time.perf_counter() - t0))
    fields = ("speech", "noisy", "spec_clean", "spec_noisy", "feat_erb", "feat_spec", "lengths",
              "max_freq", "snr", "gain", "ids")
    first = runs[0][1]
    same = len(first) == len(td) // LATEST_BATCH > 0 and all(
        len(epoch) == len(first) and all(np.array_equal(getattr(a, f), getattr(b, f))
                                         for a, b in zip(first, epoch) for f in fields)
        for _, epoch, _ in runs[1:])
    print(f"one epoch of DataLoader(FdDataset(TdDataset)) at {LATEST_WORKERS} worker, "
          f"{len(first)} batches of {LATEST_BATCH} x 1 s, in turns: "
          + ", ".join(f"{tag} {wall:.2f} s" for tag, _, wall in runs)
          + f"; batches bit for bit equal across the formats: {same}")
    if not same:
        fail("the loader's batches differ between the two formats")
    return first[0]


def latest_corpus_path(card, smi, dev="cuda"):
    """Phase 13. Returns the launches of K1 and K2 over it."""
    import shutil

    from deepfilternet_torch.checkpoint import read_cp, write_cp
    from deepfilternet_torch.config import config
    from deepfilternet_torch.ops.fused_frontend import fused_analysis_frontend as k1
    from deepfilternet_torch.ops.whole_cell import cell_process as k2
    from deepfilternet_torch.train.run import batch_to_arrays, to_device
    from deepfilternet_torch.train.trainer import load_opt_config

    t_phase = time.perf_counter()
    k1.launches = k2.launches = 0
    with open(os.path.join(LATEST_DIR, "MANIFEST.json")) as f:
        manifest = json.load(f)
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "latest")  # the loader writes key caches beside a corpus
        shutil.copytree(LATEST_DIR, root)
        nbytes = latest_read_check(root, manifest)
        copies = os.path.join(tmp, "default")
        latest_copies(root, copies, nbytes)
        latest_tool_check(root, manifest)
        latest_merge_check(root)

        params, state, cfg, module, df_state = train_model(MODEL_DIR, dev=dev)
        first = latest_loader_check(root, copies, cfg["nb_erb"], cfg["nb_df"])
        opt_cfg = load_opt_config()
        cpu_params, cpu_state, _, _, _ = train_model(MODEL_DIR, dev="cpu")
        step_vs_cpu("DFN3 first latest-format corpus batch", card, module, cfg, df_state, params,
                    state, cpu_params, cpu_state, to_device(batch_to_arrays(first), dev),
                    opt_cfg["lr"], opt_cfg["weight_decay"])

        # train(): the demo's config and checkpoint (as epoch 0), one epoch
        base = os.path.join(tmp, "run")
        config.reset()
        config.load(os.path.join(MODEL_DIR, "config.ini"), allow_reload=True)
        for section, key, value in LATEST_TRAIN + TRAIN_LOSS:
            config.set(key, value, section=section)
        os.makedirs(base)
        config.save(os.path.join(base, "config.ini"))
        demo = read_cp(os.path.join(MODEL_DIR, "checkpoints"), "best")
        write_cp(os.path.join(base, "checkpoints"), demo["params"], demo["state"], 0)
        t0 = time.perf_counter()
        with timed_run_steps() as log:
            test_loss, lines = run_train("train()", latest_dataset_cfg(root), root, base,
                                         num_workers=LATEST_WORKERS, device=dev)
        wall = time.perf_counter() - t0
        resumed = read_cp(os.path.join(base, "checkpoints"), "latest")
        ckpts = sorted(os.listdir(os.path.join(base, "checkpoints")))
        n_steps = len(manifest["speech.hdf5"]["speech"]["keys"]) // LATEST_BATCH
        finite = all(np.isfinite(np.asarray(v)).all() for _, v in named_leaves(resumed["params"]))
        ok = (len(log) == n_steps and np.all(np.isfinite([e["loss"] for e in log]))
              and np.isfinite(test_loss) and "Resuming from epoch 0" in lines
              and any(c.startswith("model_1.ckpt") for c in ckpts)
              and resumed["epoch"] == 1 and finite)
        print(f"train() from the demo checkpoint (epoch 0) over the latest-format corpus on {smi}: "
              f"{len(log)} steps [{LATEST_BATCH}, 1 s], losses "
              + ", ".join(f"{e['loss']:.4f}" for e in log)
              + f", step median {np.median([e['ms'] for e in log]):.2f} ms (CUDA events); test "
              f"{test_loss:.4f}; checkpoints {ckpts}; read_cp('latest') resumes after epoch "
              f"{resumed['epoch']}, its weights finite: {finite}; wall {wall:.1f} s")
        if not ok:
            fail("train() over the latest-format corpus did not train, write or resume as it "
                 "should")
    phase = time.perf_counter() - t_phase
    print(f"phase 13 on {smi}: {phase:.1f} s wall (bound {LATEST_PHASE_S:.0f} s); K1 launches "
          f"{k1.launches}, K2 {k2.launches}")
    if k1.launches or k2.launches:
        fail(f"phase 13 launched K1 {k1.launches}, K2 {k2.launches} times")
    if phase > LATEST_PHASE_S:
        fail(f"phase 13 took {phase:.1f} s, more than {LATEST_PHASE_S:.0f} s")
    return k1.launches, k2.launches


# -- phase 14: in-place HDF5 edits --------------------------------------------------

# the corpus prepare_data writes: EDIT_CLIPS seeded harmonic-plus-noise speech
# clips of EDIT_SECONDS (int16, 245.8 MB of samples; a fine-tuning corpus cut
# in clip count); the merge adds EDIT_NEW clips of EDIT_SECONDS, EDIT_REPLACED
# of them over keys already there; two WAVs into the committed superblock-3
# speech.hdf5; one loader epoch of [8, EDIT_SAMPLE_S] over the merged corpus
EDIT_CLIPS, EDIT_SECONDS, EDIT_NEW, EDIT_REPLACED = 512, 5.0, 16, 2
EDIT_BATCH, EDIT_SAMPLE_S, EDIT_WORKERS = 8, 1.0, 2
EDIT_PHASE_S = 90.0


def edit_clips(n, seconds, seed):
    """n seeded harmonic-plus-noise clips in float32: five harmonics of a
    vibrato f0 (the phase wrapped to one cycle before the sine, the
    harmonics by the Chebyshev recurrence) and uniform white noise of unit
    variance: cheap enough to make 512 x 5 s inside the phase's bound."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR), dtype=np.float32) / SR
    f0 = rng.uniform(100.0, 300.0, (n, 1)).astype(np.float32)
    vib = 1.0 + 0.02 * np.sin(2 * np.pi * rng.uniform(2.0, 6.0, (n, 1)).astype(np.float32) * t)
    cycles = f0 / SR * np.cumsum(vib, axis=1, dtype=np.float32)
    phase = (2 * np.pi) * (cycles - np.floor(cycles))
    s1, c2 = np.sin(phase), 2 * np.cos(phase)
    prev, cur, speech = np.zeros_like(s1), s1, s1.copy()
    for k in range(2, 6):  # sin(k x) = 2 cos(x) sin((k - 1) x) - sin((k - 2) x)
        prev, cur = cur, c2 * cur - prev
        speech += cur / k
    noise = (rng.random(speech.shape, dtype=np.float32) - 0.5) * np.float32(2 * 3 ** 0.5)
    return speech * np.float32(0.1) + noise * rng.uniform(0.01, 0.05, (n, 1)).astype(np.float32)


def write_wavs(d, prefix, clips):
    """Each clip as a WAV by the port's save_audio; returns (paths, the int16
    samples prepare_data makes of each, as its loader reads the WAV)."""
    from deepfilternet_torch.utils.audio_io import load_audio, save_audio

    paths, want = [], []
    for i, x in enumerate(clips):
        paths.append(os.path.join(d, f"{prefix}_{i:03d}.wav"))
        save_audio(paths[-1], x, SR)
        audio, _ = load_audio(paths[-1])
        want.append(np.clip(audio * 32767.0, -32768, 32767).astype(np.int16))
    return paths, want


def file_digest(path, start, stop):
    """sha256 of a file's bytes [start, stop)."""
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        f.seek(start)
        left = stop - start
        while left:
            block = f.read(min(left, 1 << 24))
            h.update(block)
            left -= len(block)
    return h.hexdigest()


def chunk_entries(path):
    """{group/key: {chunk offset: (address, stored bytes, filter mask)}} of
    every dataset of a corpus, through H5File."""
    from deepfilternet_torch.data.h5file import H5File

    with H5File(path) as f:
        return {f"{g}/{k}": dict(f[g][k]._chunk_index())
                for g in f["/"].keys() for k in f[g].keys()}


def rewrite_merge(src, out, content, paths):
    """The merge as prepare_data made it before it edited in place: every
    clip of `src` read and written with its attributes into a new file by
    create_dataset (but the keys written again), then the new clips."""
    from deepfilternet_torch.data.h5file import H5File, H5Writer
    from deepfilternet_torch.scripts.prepare_data import sanitize_key
    from deepfilternet_torch.utils.audio_io import load_audio

    keys = {sanitize_key(p) for p in paths}
    with H5File(src) as old, H5Writer(out) as w:
        for name, value in old.attrs.items():
            w.set_attr("/", name, value)
        for g in old["/"].keys():
            for k in old[g].keys():
                if g != content or k not in keys:
                    w.create_dataset(f"{g}/{k}", old[g][k][...], attrs=old[g][k].attrs)
        w.set_attr("/", "db_id", int(time.time()))
        for p in paths:
            audio, _ = load_audio(p)
            w.create_dataset(f"{content}/{sanitize_key(p)}",
                             np.clip(audio * 32767.0, -32768, 32767).astype(np.int16),
                             attrs={"n_samples": np.array([audio.shape[-1]])})


def edit_reads_back(path, want):
    """Every key of `want` ({key: int16}) through H5File and Hdf5Dataset, bit
    for bit, and no other key."""
    from deepfilternet_torch.data.h5file import H5File
    from deepfilternet_torch.data.hdf5 import Hdf5Dataset

    ds = Hdf5Dataset(path)
    with H5File(path) as f:
        ok = sorted(f["speech"].keys()) == sorted(want) == ds.keys("speech")
        for k, v in want.items():
            ok &= (np.array_equal(f["speech"][k][...], v)
                   and np.array_equal(ds.read("speech", k), v.astype(np.float32) / 32768))
    ds.close()
    return ok


def raw_copy_check(src, copies):
    """Every dataset of the `copies` files holds the source's chunks byte for
    byte (offsets, stored sizes, filter masks, bytes) in its chunk shape.
    Returns (datasets, stored bytes) compared."""
    from deepfilternet_torch.data.h5file import H5File

    n = nbytes = 0
    with H5File(src) as f:
        for path in copies:
            with H5File(path) as g:
                for grp in g["/"].keys():
                    for k in g[grp].keys():
                        a, b = f[grp][k], g[grp][k]
                        ia, ib = a._chunk_index(), b._chunk_index()
                        if a.chunks != b.chunks or ia.keys() != ib.keys() or any(
                                ia[o][1:] != ib[o][1:]
                                or f._read(ia[o][0], ia[o][1]) != g._read(ib[o][0], ib[o][1])
                                for o in ia):
                            fail(f"{path}: {grp}/{k}'s chunks are not the source's")
                        n += 1
                        nbytes += sum(e[1] for e in ib.values())
    return n, nbytes


def edit_loader_epoch(root):
    """One epoch of DataLoader(FdDataset(TdDataset)) over the merged corpus
    (with the committed noise and RIR files): every sample's batch; returns
    (batches, wall)."""
    import shutil

    from deepfilternet_torch.data.dataloader import DataLoader
    from deepfilternet_torch.data.dataset import DatasetConfig, FdDataset, TdDataset

    for name in ("noise.hdf5", "rir.hdf5"):
        shutil.copy(os.path.join(LATEST_DIR, name), os.path.join(root, name))
    files = [[n, 1] for n in ("speech.hdf5", "noise.hdf5", "rir.hdf5")]
    with open(os.path.join(root, "dataset.cfg"), "w") as f:
        json.dump({"train": files, "valid": files, "test": files}, f)
    cfgs = DatasetConfig.open(os.path.join(root, "dataset.cfg")).split("train")
    td = TdDataset(root, cfgs, "train", sr=SR, max_len_s=EDIT_SAMPLE_S, p_reverb=0.2, seed=42)
    # DFN3's ERB bands and DF bins
    loader = DataLoader(FdDataset(td, 960, HOP, 32, 96), EDIT_BATCH, num_workers=EDIT_WORKERS,
                        drop_last=True)
    t0 = time.perf_counter()
    batches = list(loader.iter_epoch("train", 0))
    wall = time.perf_counter() - t0
    finite = all(np.isfinite(b.noisy).all() and np.isfinite(b.feat_erb).all() for b in batches)
    if len(batches) != len(td) // EDIT_BATCH or len(td) != EDIT_CLIPS + EDIT_NEW - EDIT_REPLACED \
            or not finite:
        fail(f"the loader's epoch over the merged corpus: {len(batches)} batches of {len(td)} "
             f"samples, finite {finite}")
    return len(batches), wall


def hdf5_edit_path(card, smi):
    """Phase 14. Returns the launches of K1 and K2 over it."""
    import shutil

    from deepfilternet_torch.data.h5file import H5File
    from deepfilternet_torch.ops.fused_frontend import fused_analysis_frontend as k1
    from deepfilternet_torch.ops.whole_cell import cell_process as k2
    from deepfilternet_torch.scripts import hdf5_tool
    from deepfilternet_torch.scripts.prepare_data import prepare, sanitize_key

    t_phase = time.perf_counter()
    k1.launches = k2.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        root, wav = os.path.join(tmp, "corpus"), os.path.join(tmp, "wav")
        os.makedirs(root)
        os.makedirs(wav)
        t0 = time.perf_counter()
        paths, want = [], []
        for b in range(0, EDIT_CLIPS, 16):  # 16 clips at a time: 15 MB arrays
            p, w = write_wavs(wav, f"speech_{b:03d}",
                              edit_clips(min(16, EDIT_CLIPS - b), EDIT_SECONDS, 1400 + b))
            paths += p
            want += w
        t_wavs = time.perf_counter() - t0
        corpus = os.path.join(root, "speech.hdf5")
        t0 = time.perf_counter()
        quiet(prepare, "speech", corpus, paths)
        t_write = time.perf_counter() - t0
        want = {sanitize_key(p): w for p, w in zip(paths, want)}
        nbytes = sum(v.nbytes for v in want.values())
        size = os.path.getsize(corpus)
        print(f"corpus: {EDIT_CLIPS} clips x {EDIT_SECONDS:.0f} s int16 ({nbytes / 1e6:.1f} MB of "
              f"samples, {size / 1e6:.1f} MB on disk) written by prepare_data in {t_write:.2f} s "
              f"(WAVs {t_wavs:.2f} s)")

        # the merge: EDIT_NEW clips, the first EDIT_REPLACED over keys already there
        merge_dir = os.path.join(tmp, "merge")
        os.makedirs(merge_dir)
        new_paths, new_want = write_wavs(merge_dir, "new", edit_clips(EDIT_NEW, EDIT_SECONDS, 1399))
        for i in range(EDIT_REPLACED):
            os.replace(new_paths[i], paths[i])
            new_paths[i] = paths[i]
        for p, w in zip(new_paths, new_want):
            want[sanitize_key(p)] = w
        rewritten = os.path.join(tmp, "rewrite.hdf5")
        t0 = time.perf_counter()
        rewrite_merge(corpus, rewritten, "speech", new_paths)
        t_rewrite, rewrite_bytes = time.perf_counter() - t0, os.path.getsize(rewritten)
        os.remove(rewritten)
        before = file_digest(corpus, 96, size)
        t0 = time.perf_counter()
        quiet(prepare, "speech", corpus, new_paths)
        t_merge = time.perf_counter() - t0
        shutil.rmtree(wav)
        grown = os.path.getsize(corpus) - size
        prefix_ok = file_digest(corpus, 96, size) == before
        read_ok = edit_reads_back(corpus, want)
        entries = chunk_entries(corpus)
        new_stored = sum(e[1] for p in new_paths
                         for e in entries[f"speech/{sanitize_key(p)}"].values())
        # the metadata written: the new clips' headers and chunk B-trees, the
        # speech group's symbol table and the root anew, a global heap
        meta, meta_bound = grown - new_stored, 4096 * (EDIT_NEW + 1) + 128 * len(want)
        print(f"in-place merge of {EDIT_NEW} WAVs of {EDIT_SECONDS:.0f} s ({EDIT_REPLACED} over "
              f"keys there) into the {EDIT_CLIPS}-clip corpus (host of {smi}): {t_merge:.3f} s "
              f"wall, file grown by {grown} bytes ({new_stored} of new chunks, {meta} of "
              f"metadata, bound {meta_bound}); the old way (read every clip, write a new file "
              f"by create_dataset): {t_rewrite:.3f} s, {rewrite_bytes} bytes written "
              f"({t_rewrite / t_merge:.1f}x the time, {rewrite_bytes / grown:.1f}x the bytes); "
              f"the old bytes outside the superblock unchanged: {prefix_ok}; {len(want)} keys "
              f"bit for bit through H5File and Hdf5Dataset: {read_ok}")
        if not (prefix_ok and read_ok and 0 < meta <= meta_bound):
            fail("the in-place merge is wrong")

        # fix in place: headers anew, every chunk where it was
        chunks, size = entries, os.path.getsize(corpus)
        before = file_digest(corpus, 96, size)
        t0 = time.perf_counter()
        _, fix_lines = quiet(hdf5_tool.main, ["fix", corpus])
        t_fix, fix_grown = time.perf_counter() - t0, os.path.getsize(corpus) - size
        with H5File(corpus) as f:
            attrs_ok = all(int(f["speech"][k].attrs["n_samples"]) == v.shape[-1]
                           and int(f["speech"][k].attrs["n_channels"]) == 1
                           for k, v in want.items())
        fix_ok = (chunk_entries(corpus) == chunks and file_digest(corpus, 96, size) == before
                  and attrs_ok)
        print(f"hdf5_tool fix in place: '{fix_lines[-1]}' in {t_fix:.3f} s wall, file grown by "
              f"{fix_grown} bytes; every chunk index entry as before, the old bytes unchanged, "
              f"n_samples and n_channels right: {fix_ok}")
        if not fix_ok:
            fail("hdf5_tool fix in place is wrong")

        # split and trim: the chunks copied raw
        rates = {}
        for cmd in ("split", "trim"):
            out = os.path.join(tmp, cmd)
            os.makedirs(out)
            if cmd == "split":
                argv = ["split", corpus, out, "--ratios", "0.8,0.1,0.1"]
            else:
                argv = ["trim", corpus, os.path.join(out, "trim.hdf5"), "--max-len-s",
                        str(EDIT_SECONDS)]
            t0 = time.perf_counter()
            _, lines = quiet(hdf5_tool.main, argv)
            wall = time.perf_counter() - t0
            copies = [os.path.join(out, n) for n in sorted(os.listdir(out))]
            n, stored = raw_copy_check(corpus, copies)
            if n != len(want):
                fail(f"hdf5_tool {cmd} copied {n} of {len(want)} clips")
            rates[cmd] = (wall, nbytes / wall / 1e6, stored / wall / 1e6, lines[-1])
            shutil.rmtree(out)
        print("raw chunk copies (chunks byte for byte the source's, in its chunk shape): "
              + "; ".join(f"{cmd} '{line}' {wall:.3f} s, {rate:.0f} MB/s of samples "
                          f"({srate:.0f} MB/s stored)"
                          for cmd, (wall, rate, srate, line) in rates.items()))

        latest = os.path.join(tmp, "latest")
        os.makedirs(latest)
        shutil.copy(os.path.join(LATEST_DIR, "speech.hdf5"), latest)
        latest_merge_check(latest)
        batches, wall = edit_loader_epoch(root)
        print(f"one epoch of DataLoader(FdDataset(TdDataset)) at {EDIT_WORKERS} workers over the "
              f"merged corpus: {batches} batches of {EDIT_BATCH} x {EDIT_SAMPLE_S:.0f} s in "
              f"{wall:.2f} s ({batches * EDIT_BATCH / wall:.1f} samples/s)")
    phase = time.perf_counter() - t_phase
    print(f"phase 14 on {smi}: {phase:.1f} s wall (bound {EDIT_PHASE_S:.0f} s); K1 launches "
          f"{k1.launches}, K2 {k2.launches}")
    if k1.launches or k2.launches:
        fail(f"phase 14 launched K1 {k1.launches}, K2 {k2.launches} times")
    if phase > EDIT_PHASE_S:
        fail(f"phase 14 took {phase:.1f} s, more than {EDIT_PHASE_S:.0f} s")
    return k1.launches, k2.launches


# -- phase 15: BASELINE.json's configuration matrix ----------------------------------

MATRIX_PHASE_S = 120.0
LOW_LATENCY = {("FFT_SIZE", "DF"): "480", ("HOP_SIZE", "DF"): "240", ("NB_DF", "DF"): "48"}
# tests/test_configs.py's DFN2 keys; one DF iteration is what its streaming cell runs
DFN2_KEYS = {("GRU_TYPE", "deepfilternet"): "squeeze",
             ("DF_OUTPUT_LAYER", "deepfilternet"): "groupedlinear",
             ("DFOP_METHOD", "deepfilternet"): "complex_strided",
             ("DF_N_ITER", "deepfilternet"): "1"}
ERB_COUNTS = {("NB_ERB", "DF"): "24", ("NB_DF", "DF"): "64"}
MATRIX_STREAMS = (1, 17, 37, 64, 4096)
MATRIX_ROWS, MATRIX_CPU_ROWS = 16, 2  # the secondary configurations' streams, and the CPU's


def seeded_models(keys, model_name=None, cpu=True):
    """A random-init model (init_model's seeded generator) under the config
    `keys` on the card and, with `cpu`, the same weights on the CPU; the
    config is reset before and after. Returns (model, df_state, cpu_model,
    cpu_state)."""
    from deepfilternet_torch.config import config
    from deepfilternet_torch.enhance import init_df

    config.reset()
    try:
        for (key, section), value in keys.items():
            config.set(key, value, section=section)
        model, df_state, _ = init_df(model_name=model_name)
        cpu_model, cpu_state = (init_df(model_name=model_name, device="cpu")[:2] if cpu
                                else (None, None))
    finally:
        config.reset()
    if cpu:
        for (name, a), (_, b) in zip(named_leaves(model.params), named_leaves(cpu_model.params)):
            if not torch.equal(a.cpu(), b):
                fail(f"seeded {model_name} weights differ between the card and the CPU at {name}")
    return model, df_state, cpu_model, cpu_state


def configuration_matrix_path(dev, card, smi):
    """Phase 15: K1 against its plain version at every geometry of
    K1_SHAPES and MATRIX_STREAMS, timed at DFN3-ll's; a seeded DFN3 at FFT
    480 / hop 240 / 48 DF bins through StreamingRuntime.process (64 x 2 s,
    K1 once a frame) against the CPU, at bfloat16, through
    enhance(backend="scan") and a hop-240 server (16 clients x 2 s, bit for
    bit StreamingRuntime.process); DFN2 and DFN1 per frame at
    that configuration; 24 ERB / 64 DF bins per frame against the CPU;
    DF_ORDER 1-5 per frame against the offline forward; the whole cell
    refusing the low-latency configuration. Returns K1's entries."""
    import multiprocessing as mp

    from deepfilternet_torch.enhance import enhance
    from deepfilternet_torch.ops.whole_cell import cell_process as k2
    from deepfilternet_torch.streaming_whole_cell import WholeCellStreamingRuntime

    t_phase = time.perf_counter()
    steps = {}

    def lap(name):
        steps[name] = time.perf_counter() - t_phase - sum(steps.values())

    entry = {"matrix_max_abs_err": max(check_frontend_shape(dev, shape, MATRIX_STREAMS)
                                       for shape in K1_SHAPES)}
    empty = empty_launch_ms()
    dev_ms = device_ms_fresh([(K1_LOW_LATENCY, 64), (K1_LOW_LATENCY, 4096)])
    for s in (64, 4096):
        t = time_frontend(dev, card, s, empty, dev_ms[K1_LOW_LATENCY, s], K1_LOW_LATENCY)
        entry.update({f"ll_s{s}_{k}": t[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                                     "bound_by", "library_ms")})
    lap("K1 alone")

    # DFN3-ll: the per-frame runtimes, the scan backend and the server
    model, df_state, cpu_model, cpu_state = seeded_models(LOW_LATENCY)
    hop = df_state.hop_size
    got = (df_state.fft_size, hop, df_state.delay, model.cfg["nb_df"], model.cfg["freq_bins"])
    if got != (480, 240, 240, 48, 241):
        fail(f"DFN3-ll: (fft, hop, delay, nb_df, bins) {got}")
    tag = "DFN3-ll (seeded random weights, FFT 480 / hop 240 / 48 DF bins)"
    audio = noisy_speech_like(64, SECONDS, seed=15)
    run = main_path(card, model, df_state, cpu_model, cpu_state, audio, tag,
                    cpu_rows=MATRIX_CPU_ROWS, scan_rows=MATRIX_ROWS)
    entry["ll_launches"], entry["ll_scan_launches"] = run["launches"], run["scan_launches"]
    lap("DFN3-ll float32, scan")

    bf16 = main_path(card, model, df_state, cpu_model, cpu_state, audio, tag,
                     dtype=torch.bfloat16, cpu_rows=MATRIX_CPU_ROWS, cpu_frames=100, tol=0.05,
                     err_fn=scale_err)
    e_f32 = scale_err(bf16["out"], run["out"])
    if not e_f32 <= BF16_DRIFT_TOL:
        fail(f"{tag} bfloat16: vs float32 {e_f32:.3e} (tol {BF16_DRIFT_TOL}) of the largest "
             "value")
    print(f"{tag} bfloat16 vs the float32 run: {e_f32:.3e} of the largest value (tol "
          f"{BF16_DRIFT_TOL})")
    entry["ll_bf16_launches"] = bf16["launches"]
    lap("bfloat16")

    with mp.get_context("spawn").Pool(CLIENT_PROCS) as pool:
        pool.map(_client_process_ready, range(4 * CLIENT_PROCS), chunksize=1)
        served = served_family(tag, smi, model, df_state, audio, pool, clients=SERVE8_SLOTS,
                               seconds=SECONDS)
    entry["ll_server_replays"] = served["server_replays"]
    lap("server")

    # the whole cell takes DFN3's default geometry only, as JAX's does
    k2.launches = 0
    try:
        WholeCellStreamingRuntime(model, df_state)
    except AssertionError:
        pass
    else:
        fail("WholeCellStreamingRuntime took the low-latency configuration")
    if k2.launches:
        fail(f"the refused whole cell launched K2 {k2.launches} times")
    print(f"WholeCellStreamingRuntime at {tag}: refused (AssertionError, as JAX's "
          "PallasStreamingRuntime), K2 launches 0")

    # DFN2 and DFN1 at the low-latency configuration, 24 ERB / 64 DF bins:
    # per frame on 16 x 1 s, the CPU on its first streams and 100 frames
    short = audio[:MATRIX_ROWS, : int(SR * 1.0)]
    for key, keys, name in (("ll_dfn2", {**LOW_LATENCY, **DFN2_KEYS}, "deepfilternet2"),
                            ("ll_dfn1", LOW_LATENCY, "deepfilternet"),
                            ("erb24_df64", ERB_COUNTS, None)):
        fm, fd, cm, cd = seeded_models(keys, name)
        label = (f"{key} ({fm.module.__name__.rsplit('.', 1)[1]}, seeded, FFT {fd.fft_size} / "
                 f"hop {fd.hop_size} / {fm.cfg['nb_erb']} ERB / {fm.cfg['nb_df']} DF bins)")
        entry[f"{key}_launches"] = main_path(card, fm, fd, cm, cd, short, label,
                                             cpu_rows=MATRIX_CPU_ROWS, cpu_frames=100)["launches"]
    lap("DFN2, DFN1, 24/64")

    # DF_ORDER 1-5: per frame against the offline forward on the card, at
    # JAX's own bound for the pair (tests/test_configs.py: 2e-4)
    x = audio[:4, : int(SR * 1.0)]
    errs, entry["df_order_launches"] = [], 0
    for order in range(1, 6):
        om, od, _, _ = seeded_models({("DF_ORDER", "DF"): str(order)}, cpu=False)
        o = main_path(card, om, od, None, None, x, f"DF_ORDER {order} (seeded DFN3)")
        err = max_abs_err(o["out"], enhance(om, od, x, pad=False))
        if om.cfg["df_order"] != order or not err <= 2e-4:
            fail(f"DF_ORDER {order}: cfg order {om.cfg['df_order']}, per frame vs offline "
                 f"{err:.3e} (tol 2e-4)")
        errs.append(err)
        entry["df_order_launches"] += o["launches"]
    print(f"DF_ORDER 1-5 (seeded DFN3) StreamingRuntime.process [4, 1 s] against "
          f"enhance(pad=False) on {card}: max abs err " + ", ".join(f"{e:.2e}" for e in errs)
          + f" (tol 2e-4); K1 launches {entry['df_order_launches']} in all")

    lap("DF orders")
    phase = time.perf_counter() - t_phase
    print(f"phase 15 on {smi}: {phase:.1f} s wall (bound {MATRIX_PHASE_S:.0f} s): "
          + ", ".join(f"{k} {v:.1f} s" for k, v in steps.items()))
    if phase > MATRIX_PHASE_S:
        fail(f"phase 15 took {phase:.1f} s, more than {MATRIX_PHASE_S:.0f} s")
    return entry


# -- phase 16: the last slices ---------------------------------------------------------

# the phase took 73.6 s in the whole script on an NVIDIA H100 80GB HBM3
# (700 W) and its host, two trainer processes' start-up among it
LAST_PHASE_S = 120.0
# the wrapper's corpus {name: (clips, seconds)} and [train] keys: three epochs
# of 2 steps of 4 x 3 s
WRAPPER_CORPUS = {"speech": (8, 3.0), "noise": (4, 3.0), "rir": (2, 0.5), "valid": (4, 3.0)}
WRAPPER_EPOCHS = 3
WRAPPER_TRAIN = (("train", "MAX_EPOCHS", str(WRAPPER_EPOCHS)), ("train", "BATCH_SIZE", "4"),
                 ("train", "MAX_SAMPLE_LEN_S", "3"), ("train", "EARLY_STOPPING_PATIENCE", "5"))
WRAPPER_TIMEOUT_S = 300
# the module the port's wrapper runs
TRAINER = "deepfilternet_torch.train.run"
# the VTLP pool's source corpus and warps
VTLP_CORPUS = {"clean": (16, 5.0), "noise_flac": (4, 5.0)}
VTLP_ALPHAS = (0.9, 0.95, 1.05, 1.1)


def low_latency_training(dev, card, smi):
    """Phase 16 (a): DFN3-ll (seeded random weights at the default widths,
    FFT 480 / hop 240 / 48 DF bins) one train step card vs CPU on 4 x 3 s at
    phase 9's bounds, 20 timed steps on 8 x 3 s, then the stepped weights
    through write_cp, config.save and init_df into StreamingRuntime.process
    on 64 x 2 s (K1 once a frame, 400 frames) against the CPU at 1e-4.
    Returns K1's launches in that run."""
    from deepfilternet_torch.checkpoint import write_cp
    from deepfilternet_torch.config import config
    from deepfilternet_torch.enhance import init_df
    from deepfilternet_torch.train.trainer import load_opt_config, make_train_step

    opt_cfg = load_opt_config()
    lr, wd = opt_cfg["lr"], opt_cfg["weight_decay"]
    params, state, cfg, module, df_state = train_model(name="deepfilternet3", dev=dev,
                                                       keys=LOW_LATENCY)
    cpu_params, cpu_state, _, _, _ = train_model(name="deepfilternet3", dev="cpu",
                                                 keys=LOW_LATENCY)
    got = (df_state.fft_size, df_state.hop_size, cfg["nb_erb"], cfg["nb_df"], cfg["freq_bins"])
    if got != (480, 240, 32, 48, 241):
        fail(f"DFN3-ll training: (fft, hop, nb_erb, nb_df, bins) {got}")
    for (name, a), (_, b) in zip(named_leaves(params), named_leaves(cpu_params)):
        if not torch.equal(a.cpu(), b):
            fail(f"seeded DFN3-ll weights differ between the card and the CPU at {name}")
    tag = "DFN3-ll training (seeded, FFT 480 / hop 240 / 48 DF bins)"
    walls = {}
    t0 = time.perf_counter()
    batch = train_batch(df_state, cfg["nb_df"], 4, TRAIN_SECONDS, seed=161, dev=dev)
    ts, _ = step_vs_cpu(tag, card, module, cfg, df_state, params, state, cpu_params, cpu_state,
                        batch, lr, wd)
    walls["step card vs CPU"] = time.perf_counter() - t0
    batch8 = train_batch(df_state, cfg["nb_df"], 8, TRAIN_SECONDS, seed=162, dev=dev)
    step = make_train_step(module, cfg, train_loss(cfg, df_state))
    ts = timed_steps(tag, card, smi, step, ts, batch8, lr, wd, TRAIN_STEPS)
    walls[f"{TRAIN_STEPS} steps"] = time.perf_counter() - t0 - sum(walls.values())

    # the stepped weights as a user loads them: write_cp and the config
    with tempfile.TemporaryDirectory() as model_dir:
        write_cp(os.path.join(model_dir, "checkpoints"), ts.params, ts.model_state, ts.step,
                 is_best=True)
        config.save(os.path.join(model_dir, "config.ini"))
        model, mstate, suffix = init_df(model_dir, device=dev)
        cpu_model, cpu_mstate, _ = init_df(model_dir, device="cpu")
    config.reset()
    same = all(torch.equal(a.detach(), b) for (_, a), (_, b)
               in zip(named_leaves(ts.params), named_leaves(model.params)))
    if not (same and suffix == f"e{ts.step}" and mstate.hop_size == 240):
        fail(f"{tag}: the stepped weights did not load back ({suffix}, bit for bit {same}, "
             f"hop {mstate.hop_size})")
    walls["write_cp, init_df"] = time.perf_counter() - t0 - sum(walls.values())
    audio = noisy_speech_like(64, SECONDS, seed=16)
    run = main_path(card, model, mstate, cpu_model, cpu_mstate, audio,
                    f"{tag} after {ts.step} steps, per frame", cpu_rows=MATRIX_CPU_ROWS)
    walls["per frame, card and CPU"] = time.perf_counter() - t0 - sum(walls.values())
    print(f"{tag} walls: " + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()))
    if run["launches"] != 400:
        fail(f"{tag}: K1 launched {run['launches']} times in 400 frames")
    return run["launches"]


def _descendants(pid):
    """The pids of every process below `pid`, from /proc/*/stat."""
    parent = {}
    for name in os.listdir("/proc"):
        if name.isdigit():
            try:
                with open(f"/proc/{name}/stat") as f:
                    parent[int(name)] = int(f.read().rsplit(")", 1)[1].split()[1])
            except OSError:
                continue
    out, todo = [], [pid]
    while todo:
        above = todo.pop()
        kids = [c for c, p in parent.items() if p == above]
        out += kids
        todo += kids
    return out


def kill_tree(proc):
    """Kill `proc` and every process below it, and reap `proc`."""
    for pid in [*_descendants(proc.pid), proc.pid]:
        try:
            os.kill(pid, 9)
        except ProcessLookupError:
            pass
    proc.wait()


def trainer_pid(wrapper_pid, module=TRAINER):
    """The trainer below the wrapper: the Python interpreter (not a shell
    script named python3) running `module`."""
    for pid in _descendants(wrapper_pid):
        try:
            exe = os.path.basename(os.readlink(f"/proc/{pid}/exe"))
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().split(b"\0")
        except OSError:
            continue
        if exe.startswith("python") and module.encode() in cmd:
            return pid
    return None


def sigusr1_resubmit(wrapper, args, root, module=TRAINER, timeout_s=WRAPPER_TIMEOUT_S):
    """Run the cluster wrapper `wrapper` with `args` (DATA_CFG DATA_DIR
    BASE_DIR, then the trainer's extra arguments) from the repository's root,
    and send SIGUSR1 to its trainer (the Python process running `module`,
    found below the wrapper in /proc; not the wrapper, whose bash would die of
    it) once the trainer's first epoch line has printed. A `python` and a
    `python3` first on PATH run this interpreter and record after each trainer
    run whether BASE_DIR/continue exists (the resubmitted wrapper removes
    it). A watchdog kills the whole tree after `timeout_s`. Returns what the
    run showed: its exit code, the trainer's and the wrapper's pids, those
    records, the epoch `continue` held, the resubmissions, the epochs before
    and after the resubmission, the `Resuming from` epochs, the final test
    losses, whether `continue` was left, the wall seconds, and the lines."""
    import signal
    import threading

    here = os.path.dirname(os.path.abspath(__file__))
    base = args[2]
    bin_dir = os.path.join(root, "bin")
    os.makedirs(bin_dir)
    log = os.path.join(root, "continue.log")
    for name in ("python", "python3"):
        with open(os.path.join(bin_dir, name), "w") as f:
            f.write(f'#!/bin/sh\n"{sys.executable}" "$@"\nrc=$?\n'
                    f'if [ -f "$5/continue" ]; then echo "continue $(cat "$5/continue")" >> "{log}"\n'
                    f'else echo "no continue" >> "{log}"; fi\nexit $rc\n')
        os.chmod(os.path.join(bin_dir, name), 0o755)
    env = dict(os.environ, PATH=f"{bin_dir}{os.pathsep}{os.environ.get('PATH', '')}",
               PYTHONPATH=here, PYTHONUNBUFFERED="1", OPENBLAS_NUM_THREADS="1")
    env.pop("SLURM_JOB_NAME", None)
    t0 = time.perf_counter()
    proc = subprocess.Popen([wrapper, *args], cwd=here, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    # the whole tree goes at the time limit: the trainer holds the pipe open
    watchdog = threading.Timer(timeout_s, kill_tree, (proc,))
    watchdog.start()
    lines, signalled, marks = [], None, {}
    try:
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))
            print(f"  {os.path.basename(wrapper)}: {lines[-1]}")
            for mark in ("epoch 0: train loss", "continue file found", "Resuming from"):
                if line.startswith(mark):
                    marks.setdefault(mark, time.perf_counter() - t0)
            if signalled is None and line.startswith("epoch 0: train loss"):
                signalled = trainer_pid(proc.pid, module)
                if signalled is None:
                    kill_tree(proc)
                    break
                os.kill(signalled, signal.SIGUSR1)
        rc = proc.wait(timeout=60)
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            kill_tree(proc)
    wall = time.perf_counter() - t0
    records = open(log).read().splitlines() if os.path.exists(log) else []
    resubmit = "continue file found - resubmitting"
    at = lines.index(resubmit) if resubmit in lines else len(lines)

    def epochs(part):
        return [int(ln.split()[1].rstrip(":")) for ln in part if ": train loss" in ln]

    return {
        "rc": rc, "trainer": signalled, "wrapper": proc.pid, "records": records,
        "stopped": int(records[0].split()[1]) if records[:1] and
        records[0].startswith("continue ") else None,
        "sigusr1_lines": lines.count("SIGUSR1 received; wrote continue file"),
        "resubmits": lines.count(resubmit),
        "first": epochs(lines[:at]), "resumed": epochs(lines[at:]),
        "resumed_from": [int(ln.split()[-1]) for ln in lines[at:]
                         if ln.startswith("Resuming from epoch ")],
        "final_test_losses": sum(ln.startswith("final test loss") for ln in lines),
        "continue_left": os.path.exists(os.path.join(base, "continue")),
        "wall": wall, "timed_out": wall >= timeout_s, "marks": marks, "lines": lines,
    }


def resumed_as_it_should(run, epochs):
    """Whether a `sigusr1_resubmit` run of `epochs` epochs stopped after the
    epoch it was signalled in (or the next), wrote that epoch to `continue`,
    resubmitted once, resumed after that epoch, trained only the later
    epochs, and ended with exit 0, two final test losses and no `continue`."""
    stopped = run["stopped"]
    return (run["rc"] == 0 and run["trainer"] not in (None, run["wrapper"])
            and stopped is not None and stopped < epochs - 1
            and run["records"] == [f"continue {stopped}", "no continue"]
            and run["sigusr1_lines"] == 1 and run["resubmits"] == 1
            and run["first"] == list(range(stopped + 1))
            and run["resumed_from"] == [stopped]
            and run["resumed"] == list(range(stopped + 1, epochs))
            and run["final_test_losses"] == 2 and not run["continue_left"]
            and not run["timed_out"])


def cuda_train_wrapper(smi, root):
    """Phase 16 (b): deepfilternet_torch/scripts/cuda_train.sh over a corpus
    of a few clips, --device cuda, three epochs, SIGUSR1 to the trainer once
    its first epoch line has printed (`sigusr1_resubmit`): it must stop,
    resubmit once and resume as `resumed_as_it_should` says, and leave the
    last epoch's checkpoint. Returns the wall seconds."""
    from deepfilternet_torch.config import config

    wrapper = os.path.join("deepfilternet_torch", "scripts", "cuda_train.sh")
    if not os.access(wrapper, os.X_OK):
        fail(f"{wrapper} is not executable")
    data = os.path.join(root, "wrapper_data")
    os.makedirs(data)
    with contextlib.redirect_stdout(open(os.devnull, "w")):
        write_corpus(data, WRAPPER_CORPUS)
    base = os.path.join(root, "wrapper_run")
    os.makedirs(base)
    config.reset()
    config.load(os.path.join(MODEL_DIR, "config.ini"), allow_reload=True)
    for section, key, value in WRAPPER_TRAIN + TRAIN_LOSS:
        config.set(key, value, section=section)
    config.save(os.path.join(base, "config.ini"))
    config.reset()
    run = sigusr1_resubmit(os.path.abspath(wrapper),
                           [os.path.join(data, "dataset.cfg"), data, base,
                            "--device", "cuda", "--num-workers", "2"], root)
    last = os.path.join(base, "checkpoints", f"model_{WRAPPER_EPOCHS - 1}.ckpt")
    print(f"cuda_train.sh --device cuda on {smi}: SIGUSR1 to the trainer (pid {run['trainer']}, "
          f"not the wrapper {run['wrapper']}) after its first epoch line; continue held epoch "
          f"{run['stopped']}; the wrapper resubmitted {run['resubmits']} time(s), the resumed "
          f"run trained epochs {run['resumed']}; after each trainer run: {run['records']}; exit "
          f"{run['rc']}, continue left: {run['continue_left']}; {run['wall']:.1f} s wall for "
          f"two trainer processes ("
          + ", ".join(f"'{k}' at {v:.1f} s" for k, v in run["marks"].items()) + ")")
    if not (resumed_as_it_should(run, WRAPPER_EPOCHS) and os.path.isfile(last)):
        fail("cuda_train.sh did not stop, resubmit and resume as it should")
    return run["wall"]


def vtlp_pool_path(smi, root):
    """Phase 16 (c): the port's make_vtlp_pool over a clean corpus of
    VTLP_CORPUS (no h5py): audio seconds written a wall second; the pool read
    back through Hdf5Dataset (every warp of every key, finite, the source's
    length, not the source); then train_demo's loader with the pool as its
    DEMO_EXTRA_CLEAN, its length by the pool's sampling factor, samples of
    the pool's keys through FdDataset and collate. Returns (audio seconds a
    wall second, wall seconds)."""
    from deepfilternet_torch.data.dataloader import collate
    from deepfilternet_torch.data.hdf5 import Hdf5Dataset
    from deepfilternet_torch.scripts.make_vtlp_pool import main as make_pool
    from deepfilternet_torch.scripts.train_demo import demo_loader

    assets = os.path.join(root, "vtlp_assets")
    os.makedirs(assets)
    write_demo_corpus(assets, VTLP_CORPUS)
    src, pool = os.path.join(assets, "clean.hdf5"), os.path.join(assets, "clean_vtlp.hdf5")
    t0 = time.perf_counter()
    line = captured(make_pool, [src, pool, "--alphas", ",".join(f"{a:g}" for a in VTLP_ALPHAS)])
    wall = time.perf_counter() - t0
    n_clips, seconds = VTLP_CORPUS["clean"]
    n_pool = n_clips * len(VTLP_ALPHAS)
    audio_s = n_pool * seconds
    orig, ds = Hdf5Dataset(src), Hdf5Dataset(pool)
    keys = orig.keys("speech")
    want = sorted(f"{k}_vtlp{a:g}" for k in keys for a in VTLP_ALPHAS)
    bad = []
    for k in keys:
        a = orig.read("speech", k)
        for alpha in VTLP_ALPHAS:
            w = ds.read("speech", f"{k}_vtlp{alpha:g}")
            if not (w.shape == a.shape and np.isfinite(w).all() and np.abs(w).max() > 0.01
                    and not np.allclose(w, a, atol=1e-3)):
                bad.append(f"{k}_vtlp{alpha:g}")
    same_keys = ds.keys("speech") == want
    orig.close()
    ds.close()

    old = {k: os.environ.get(k) for k in ("DEMO_ASSETS", "DEMO_EXTRA_CLEAN")}
    os.environ.update(DEMO_ASSETS=assets, DEMO_EXTRA_CLEAN=f"{os.path.basename(pool)}:1")
    try:
        fd = demo_loader().dataset
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    td = fd.td
    picked = [i for i, (f, _) in enumerate(td.sp_index) if f == os.path.basename(pool)][:4]
    batch = collate([fd.get_sample(i, seed=i) for i in picked])
    mixes = (len(picked) == 4 and np.isfinite(batch.noisy).all()
             and np.isfinite(batch.feat_erb).all() and not np.allclose(batch.speech, batch.noisy))
    n_td = len(td)
    print(f"make_vtlp_pool (the port's, no h5py) on the card's host, {smi}: {n_clips} clips x "
          f"{seconds} s at {len(VTLP_ALPHAS)} warps -> {n_pool} clips, {audio_s:.0f} s of audio "
          f"in {wall:.2f} s wall, {audio_s / wall:.1f} audio s a wall s; '{line.strip()}'; read "
          f"back through Hdf5Dataset: keys as asked {same_keys}, bad clips {bad}; train_demo's "
          f"loader with DEMO_EXTRA_CLEAN={os.path.basename(pool)}:1: {n_td} samples (clean "
          f"{n_clips} x 16 + pool {n_pool} x 1), 4 of the pool's mixed through FdDataset and "
          f"collate: finite and not the clean speech: {mixes}")
    if not (line.strip() == f"wrote {pool}: {n_pool} clips ({len(VTLP_ALPHAS)} warps)"
            and same_keys and not bad and n_td == n_clips * 16 + n_pool and mixes):
        fail("make_vtlp_pool's pool is wrong or does not feed the demo loader")
    return audio_s / wall, wall


def last_slices_path(dev, card, smi):
    """Phase 16: DFN3-ll trained on the card and run through K1; the cluster
    wrapper cuda_train.sh; the port's make_vtlp_pool. Returns K1's and K2's
    launches over the phase."""
    from deepfilternet_torch.ops.fused_frontend import fused_analysis_frontend as k1
    from deepfilternet_torch.ops.whole_cell import cell_process as k2

    t_phase = time.perf_counter()
    steps = {}

    def lap(name):
        steps[name] = time.perf_counter() - t_phase - sum(steps.values())

    k2.launches = 0
    ll_launches = low_latency_training(dev, card, smi)
    lap("DFN3-ll training and per frame")
    k1.launches = 0
    with tempfile.TemporaryDirectory() as root:
        cuda_train_wrapper(smi, root)
        lap("cuda_train.sh")
        rate, _ = vtlp_pool_path(smi, root)
        lap("make_vtlp_pool")
    phase = time.perf_counter() - t_phase
    print(f"phase 16 K1 launches: {ll_launches} in the stepped DFN3-ll's 400 frames, "
          f"{k1.launches} over the wrapper and the pool (the trainer's own processes are "
          f"not counted here); K2 launches {k2.launches}")
    print(f"phase 16 on {smi}: {phase:.1f} s wall (bound {LAST_PHASE_S:.0f} s): "
          + ", ".join(f"{k} {v:.1f} s" for k, v in steps.items())
          + f"; VTLP pool {rate:.1f} audio s a wall s")
    if k1.launches or k2.launches:
        fail(f"phase 16: the wrapper and the pool launched K1 {k1.launches} times, or the "
             f"phase launched K2 {k2.launches} times")
    if phase > LAST_PHASE_S:
        fail(f"phase 16 took {phase:.1f} s, more than {LAST_PHASE_S:.0f} s")
    return ll_launches, k2.launches


def ptxas_report(log, kernel):
    """'function build: N registers, spills' for each kernel whose name starts
    with `kernel` in a `-Xptxas -v` log (the function, e.g. whole_cell_kernel
    or whole_cell_recording, the build that times its stages, and the build
    named by its operand type)."""
    name, spills, out = None, {}, []
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([^' ]+)", line)
        if m:
            name = m.group(1)
            continue
        if not name or kernel not in name:
            continue
        fn = re.search(r"\d+(%s[a-z_]*)" % re.escape(kernel), name)
        short = f"{fn.group(1) if fn else kernel} {'bfloat16' if 'bfloat16' in name else 'float32'}"
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills[short] = f"{m.group(1)} B spill stores, {m.group(2)} B spill loads"
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append(f"{short}: {m.group(1)} registers, {spills.get(short, 'spills not shown')}")
    return out


def hmma_counts(path):
    """{kernel: HMMA instructions in its SASS} of a built library, from
    `cuobjdump -sass` (shipped with the CUDA toolkit beside nvcc); a kernel's
    name is shortened to its function, operand type, row count and whether
    it is the instance that records its stages."""
    from deepfilternet_torch import kernels

    tool = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            mangled = m.group(1)
            base = re.search(r"\d+(whole_cell_[a-z]+|[a-z_]+kernel|[a-z_]+frontend[a-z_]*)",
                             mangled)
            rows = re.search(r"ILi(\d+)E", mangled)
            name = ((base.group(1) if base else mangled)
                    + (" bfloat16" if "__nv_bfloat16" in mangled else "")
                    + (f" R={rows.group(1)}" if rows else ""))
            counts[name] = 0
        elif name is not None and "HMMA" in line:
            counts[name] += 1
    return counts


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    from deepfilternet_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; TF32 off "
          "(torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False), "
          "bfloat16 products sum in float32 (allow_bf16_reduced_precision_reduction = False)")
    print(smi)

    t0 = time.perf_counter()
    built = kernels.build()
    print(f"build: {len(built)} kernel(s) in {time.perf_counter() - t0:.1f} s wall")
    for name, (secs, log) in built.items():
        print(f"  {name}: nvcc {secs:.1f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"    {line.strip()}")
        if name == "whole_cell":  # the units design's two builds, by name
            for line in ptxas_report(log, "whole_cell_"):
                print(f"    -Xptxas -v, {line}")
    # every product of the bfloat16 builds runs on the tensor cores
    for name in kernels.SOURCES:
        counts = hmma_counts(kernels.library_path(name))
        print(f"  {name}: HMMA instructions in the SASS (cuobjdump -sass): "
              + ", ".join(f"{k} {v}" for k, v in counts.items()))
        bare = [k for k, v in counts.items() if "bfloat16" in k and v == 0]
        if bare:
            fail(f"bfloat16 kernels without tensor-core instructions: {bare}")

    from deepfilternet_torch.enhance import init_df

    model, df_state, suffix = init_df(MODEL_DIR)
    if model.device.type != "cuda":
        fail(f"init_df() put the model on {model.device}")
    k1 = check_frontend(dev, card)
    worst, rt32 = check_whole_cell(dev, card, model, df_state, torch.float32)
    k2 = dict(time_whole_cell_all(dev, card, rt32, ""), max_abs_err=worst)
    cpu_model, cpu_state, _ = init_df(MODEL_DIR, device="cpu")
    audio = noisy_speech_like(64, SECONDS, seed=0)
    run = main_path(card, model, df_state, cpu_model, cpu_state, audio,
                    f"main path ({MODEL_DIR}, {suffix})", scan_rows=16, profile=True)
    k1["launches"], out, wall = run["launches"], run["out"], run["wall"]
    k2["launches"], wc_out = whole_cell_path(card, model, df_state, cpu_model, cpu_state, audio,
                                             out, wall)
    t0 = time.perf_counter()
    offline_and_chunked_path(card, model, df_state, cpu_model, cpu_state, audio, out)
    print(f"phase 5 (offline, chunked, CLI): {time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    k2b = reduced_precision_path(dev, card, model, df_state, cpu_model, cpu_state, audio, out,
                                 wc_out)
    print(f"phase 6 (reduced precision): {time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    k1["server_replays"] = serving_path(card, smi, model, df_state, audio, out)
    print(f"phase 7 (serving): {time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    for fam, entry in families_path(card, smi, audio).items():
        # K1 on the other families' main paths: launches in their per-frame
        # runs (200 frames), replays of the DFN2 server's graph
        k1.update({f"{fam.lower()}_{k}": v for k, v in entry.items()})
    print(f"phase 8 (DFN2, DFN1, DeepFilterNet-MF): {time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    # K1 on the trained DFN3's per-frame run (200 frames): training hands over
    # to the kernel path
    k1["trained_dfn3_launches"] = training_path(card, smi, audio)
    print(f"phase 9 (training): {time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    # K1 and K2 over train(): the corpus training loop reaches neither
    k1["train_run_launches"], k2["train_run_launches"] = corpus_training_path(card, smi)
    k2b["train_run_launches"] = k2["train_run_launches"]
    print(f"phase 10 (corpus training): {time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    # K1 and K2 over the evaluation: the offline enhance reaches neither
    k1["eval_launches"], k2["eval_launches"] = evaluation_path(card, smi)
    k2b["eval_launches"] = k2["eval_launches"]
    print(f"phase 11 (evaluation): {time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    # K1 once a frame on DFN2/DFN1 at bfloat16 and on the demo-trained model;
    # K1 and K2 over the export and the demo trainers, which reach neither
    entries = families_bf16_export_demo_path(card, smi, audio)
    k1.update(entries["K1"])
    k2.update(entries["K2"])
    k2b.update(entries["K2"])
    print(f"phase 12 (DFN2/DFN1 bfloat16, export, demo trainers): "
          f"{time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    # K1 and K2 over the corpus in the newer HDF5 formats, which reaches neither
    k1["latest_corpus_launches"], k2["latest_corpus_launches"] = latest_corpus_path(card, smi)
    k2b["latest_corpus_launches"] = k2["latest_corpus_launches"]
    print(f"phase 13 (corpus in the newer HDF5 formats): {time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    # K1 and K2 over the in-place HDF5 edits, which reach neither
    k1["hdf5_edit_launches"], k2["hdf5_edit_launches"] = hdf5_edit_path(card, smi)
    k2b["hdf5_edit_launches"] = k2["hdf5_edit_launches"]
    print(f"phase 14 (in-place HDF5 edits): {time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    # K1 at every geometry of BASELINE.json's configuration matrix, and its
    # launches on those configurations' per-frame paths
    k1.update(configuration_matrix_path(dev, card, smi))
    print(f"phase 15 (configuration matrix): {time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    # K1 once a frame on the DFN3-ll trained on the card; K2 over the phase,
    # the wrapper and the VTLP pool (which reach neither kernel)
    k1["ll_trained_launches"], k2["last_slices_launches"] = last_slices_path(dev, card, smi)
    k2b["last_slices_launches"] = k2["last_slices_launches"]
    print(f"phase 16 (DFN3-ll training, cuda_train.sh, make_vtlp_pool): "
          f"{time.perf_counter() - t0:.1f} s wall")

    print(smi)
    print(json.dumps({"kernels": [k1, k2, k2b]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
