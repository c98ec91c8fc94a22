"""What every traffic kind shares: the configuration, the seeded weights and
audio, the program's model built on them, the card's description and the
table of peaks.

The program under test is `deepfilternet_torch`; it is imported only inside
the functions that hand it work, never by the reference.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
from pathlib import Path
from typing import Dict, Tuple

import torch

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent

# dense peaks from NVIDIA's data sheets: float32 outside the tensor cores,
# in FLOP/s, and device memory in bytes/s; the first match on the device
# name wins
PEAKS = (("H100 PCIe", 51.2e12, 2.0e12), ("H100 NVL", 60.0e12, 3.9e12),
         ("H200", 67.0e12, 4.8e12), ("H100", 67.0e12, 3.35e12))


def peaks(device_name: str) -> Tuple[float, float]:
    """(float32 FLOP/s, bytes/s) of the card."""
    for key, flops, bw in PEAKS:
        if key in device_name:
            return flops, bw
    raise RuntimeError(f"no peak rates known for {device_name!r}")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_config(name: str) -> Dict:
    """`configs/<name>.json` as one flat dict of its keys (both sections),
    with `model`, `dtype`, `tf32` and the ERB widths."""
    from benchmark.reference.dsp import erb_widths

    raw = load_json(ROOT / "configs" / f"{name}.json")
    conf = dict(name=raw["name"], model=raw["model"], dtype=raw["dtype"], tf32=raw["tf32"],
                sections={s: dict(raw[s]) for s in ("DF", "deepfilternet")})
    for s in ("DF", "deepfilternet"):
        conf.update(raw[s])
    conf["erb_widths"] = erb_widths(conf["sr"], conf["fft_size"], conf["nb_erb"],
                                    conf["min_nb_erb_freqs"])
    return conf


def set_precision(tf32: bool):
    """Matrix products and convolutions in float32 (tf32 False) or TF32."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")


def seeded_weights(conf: Dict, seed: int, device):
    """The configuration's (params, state, statics), drawn on `device` from
    `seed` in one call (reference/layers.py)."""
    from benchmark.reference import layers, models

    pspec, sspec, statics = models.spec(conf)
    params, state = layers.materialize([pspec, sspec], seed, device)
    return params, state, statics


def clone_tree(tree):
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone_tree(v) for v in tree]
    return tree.clone()


def _ini(value) -> str:
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, (list, tuple)):
        return ",".join(str(v) for v in value)
    return str(value)


def port_model(conf: Dict, params, state, device):
    """The program's model (`deepfilternet_torch.enhance.DfModel`) and DSP
    state at the configuration, holding copies of the seeded weights. The
    program's own random draw, on the `meta` device, gives the tree it
    expects; a leaf whose path or shape differs raises."""
    from deepfilternet_torch.config import config
    from deepfilternet_torch.enhance import DfModel, init_df

    from benchmark.reference.layers import leaves

    config.reset()
    config.load(None, allow_reload=True)
    config.set("MODEL", conf["model"], section="train")
    for section, keys in conf["sections"].items():
        for k, v in keys.items():
            config.set(k.upper(), _ini(v), section=section)
    shape_model, df_state, _ = init_df(None, device="meta")
    for got, want in ((params, shape_model.params), (state, shape_model.state)):
        a = [(p, tuple(t.shape)) for p, t in leaves(got)]
        b = [(p, tuple(t.shape)) for p, t in leaves(want)]
        if a != b:
            raise RuntimeError(f"the seeded weights' tree is not the program's: "
                               f"{sorted(set(a) ^ set(b))[:6]}")
    model = DfModel(params=clone_tree(params), state=clone_tree(state), cfg=shape_model.cfg,
                    module=shape_model.module, device=torch.device(device))
    return model, df_state


def speech_like(rows: int, samples: int, seed: int, device, sr: int = 48000) -> torch.Tensor:
    """[rows, samples] float32 on `device` from `seed`: five harmonics of a
    100-300 Hz fundamental with a 2 % vibrato at 2-6 Hz, 0.1 peak, plus white
    noise at 0-10 dB SNR. Drawn on the device by one generator; the speech
    is made a few rows at a time, so that its float64 phase stays small
    beside the audio."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    r = torch.rand((rows, 4), generator=gen, device=device, dtype=torch.float64)
    f0, rate, snr_db = 100.0 + 200.0 * r[:, :1], 2.0 + 4.0 * r[:, 1:2], 10.0 * r[:, 2:3]
    t = torch.arange(samples, device=device, dtype=torch.float64)[None, :] / sr
    out = torch.randn((rows, samples), generator=gen, device=device, dtype=torch.float32)
    step = max(1, (1 << 24) // samples)
    for lo in range(0, rows, step):
        sl = slice(lo, lo + step)
        # the phase is the integral of f0 * (1 + 0.02 sin(2 pi rate t))
        phase = (2 * math.pi * f0[sl] * t - f0[sl] * 0.02 / rate[sl]
                 * torch.cos(2 * math.pi * rate[sl] * t)).remainder_(2 * math.pi)
        phase = phase.to(torch.float32)
        speech = sum(torch.sin(k * phase) / k for k in range(1, 6)) * 0.1
        noise = out[sl]
        p_s = speech.square().mean(dim=1, keepdim=True)
        p_n = noise.square().mean(dim=1, keepdim=True)
        scale = torch.sqrt(p_s / p_n / 10.0 ** (snr_db[sl].to(torch.float32) / 10.0))
        out[sl] = speech + noise * scale
    return out


def power_limit() -> str:
    """The card's power limit as nvidia-smi reads it, or "unknown"."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def env_for_run():
    """Set before anything imports the program: its caches in the checkout,
    and no JAX through any library."""
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    cache = REPO / ".bench_cache" / "kernels"
    cache.mkdir(parents=True, exist_ok=True)  # torch makes only the last part
    os.environ.setdefault("PYTORCH_KERNEL_CACHE_PATH", str(cache))


def card_peaks(dev):
    """(float32 FLOP/s, bytes/s) of the card `dev`, or None off a card."""
    if torch.device(dev).type != "cuda":
        return None
    return peaks(torch.cuda.get_device_name(dev))
