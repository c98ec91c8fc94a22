"""User-facing enhancement API and `deepFilter`-style CLI.

  * `init_df(model_base_dir, ...)` -> (model, df_state, suffix); the model
    dir may also be a `.tar.gz`/`.tgz` archive of one;
  * `df_features(audio, df_state, nb_df)` -> (spec, erb_feat, spec_feat);
  * `enhance(model, df_state, audio, pad=True, atten_lim_db=None, backend=...)`;
  * CLI: `python -m deepfilternet_torch.enhance noisy.wav [-o outdir] [--pf]
    [--device cpu] ...`.

The model is a (params, state, cfg, module) bundle on one device. Entry
points run on the CUDA device unless the caller passes `device="cpu"`; with
no GPU present they raise instead of falling back to the CPU. Delay
compensation pads by n_fft and trims d = n_fft - hop, as in the JAX package.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import shutil
import tarfile
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from deepfilternet_torch.checkpoint import params_from_numpy, read_cp
from deepfilternet_torch.config import config
from deepfilternet_torch.models import init_model
from deepfilternet_torch.ops.erb import erb_widths
from deepfilternet_torch.ops.features import erb_feat, spec_feat
from deepfilternet_torch.ops.norms import get_norm_alpha
from deepfilternet_torch.ops.stft import Stft, istft_ri, stft
from deepfilternet_torch.utils.audio_io import load_audio, resample, save_audio
from deepfilternet_torch.utils.timings import span


@dataclass
class DfState:
    """Static DSP state."""

    sr: int = 48000
    fft_size: int = 960
    hop_size: int = 480
    nb_erb: int = 32
    min_nb_erb_freqs: int = 1

    @property
    def stft_cfg(self) -> Stft:
        return Stft(sr=self.sr, fft_size=self.fft_size, hop_size=self.hop_size)

    @property
    def erb_widths(self):
        return erb_widths(self.sr, self.fft_size, self.nb_erb, self.min_nb_erb_freqs)

    @property
    def delay(self) -> int:
        return self.fft_size - self.hop_size


@dataclass
class DfModel:
    params: Any
    state: Any
    cfg: Dict
    module: Any
    device: torch.device
    post_filter: bool = False
    epoch: Optional[int] = None
    _cache: Dict = field(default_factory=dict)


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA device; raises when it is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def init_df(
    model_base_dir: Optional[str] = None,
    post_filter: bool = False,
    log_level: str = "INFO",
    config_allow_defaults: bool = True,
    epoch: str | int = "best",
    mask_only: bool = False,
    model_name: Optional[str] = None,
    device=None,
) -> Tuple[DfModel, DfState, str]:
    """Load a model + DSP state onto `device` (default: the CUDA device).

    `model_base_dir` holds `config.ini` and a `checkpoints/` dir, or is a
    `.tar.gz`/`.tgz` archive of such a dir (unpacked once into the user's
    cache); without it the live config is used with randomly initialized
    weights.
    """
    dev = resolve_device(device)
    if model_base_dir is not None and model_base_dir.endswith((".tar.gz", ".tgz")):
        model_base_dir = _unpack_archive(model_base_dir)
    if model_base_dir is not None:
        # a model dir fully defines its configuration
        config.reset()
        cfg_path = os.path.join(model_base_dir, "config.ini")
        config.load(cfg_path if os.path.isfile(cfg_path) else None,
                    allow_defaults=config_allow_defaults, allow_reload=True)
    params, state, cfg, module = init_model(model_name, device=dev)
    model = DfModel(params=params, state=state, cfg=cfg, module=module, device=dev,
                    post_filter=post_filter)
    if post_filter:
        model.cfg = dict(cfg, mask_pf=True)
    # mask-only: skip the DF stage, output the ERB-masked spectrum
    if mask_only or config("MASK_ONLY", False, bool, section="train"):
        model.cfg = dict(model.cfg, run_df=False)
    suffix = "new"
    if model_base_dir is not None:
        payload = read_cp(os.path.join(model_base_dir, "checkpoints"), which=epoch)
        if payload is not None:
            p, s = params_from_numpy(payload["params"], payload["state"], dev)
            model.params = p
            if payload["state"]:
                model.state = s
            model.epoch = payload.get("epoch")
            suffix = f"e{model.epoch}"
    df_state = DfState(
        sr=config("SR", 48000, int, section="DF"),
        fft_size=config("FFT_SIZE", 960, int, section="DF"),
        hop_size=config("HOP_SIZE", 480, int, section="DF"),
        nb_erb=model.cfg["nb_erb"],
        min_nb_erb_freqs=config("MIN_NB_ERB_FREQS", 2, int, section="DF"),
    )
    return model, df_state, suffix


def _unpack_archive(path: str) -> str:
    """Unpack a model archive into `$XDG_CACHE_HOME/deepfilternet_torch/<digest>`
    (default `~/.cache`), keyed by the archive's path, once; returns the dir."""
    digest = hashlib.sha256(path.encode()).hexdigest()[:12]
    root = os.path.join(os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache")),
                        "deepfilternet_torch")
    cache = os.path.join(root, digest)
    if not os.path.isdir(cache):
        os.makedirs(root, exist_ok=True)
        # unpack beside the cache dir and rename, so a cut-off unpack leaves
        # no half-filled cache behind
        tmp = tempfile.mkdtemp(prefix=f"{digest}.", dir=root)
        try:
            with tarfile.open(path, "r:gz") as tar:
                tar.extractall(tmp, filter="data")
            os.rename(tmp, cache)
        except OSError:
            if not os.path.isdir(cache):  # else another process unpacked it first
                raise
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return cache


def _norm_alpha(df_state: DfState) -> float:
    return get_norm_alpha(df_state.sr, df_state.hop_size,
                          config("NORM_TAU", 1.0, float, section="DF"))


def _features(audio: torch.Tensor, df_state: DfState, nb_df: int, alpha: float):
    """audio [C, T] -> (spec complex [C, T', F], erb_feat [C, T', E], spec_feat
    complex [C, T', nb_df])."""
    spec = stft(audio, df_state.stft_cfg)
    return spec, erb_feat(spec, df_state.erb_widths, alpha), spec_feat(spec, nb_df, alpha)


def _ri(x: torch.Tensor) -> torch.Tensor:
    return torch.stack([x.real, x.imag], dim=-1)


def df_features(audio, df_state: DfState, nb_df: int, alpha: Optional[float] = None,
                device=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(spec [C, T, F, 2], erb_feat [C, T, E], spec_feat [C, T, F', 2]) of
    audio [C, T] on `device` (default: the CUDA device): streaming-semantics
    STFT, dB ERB features with the exponential mean norm, unit-normalized
    complex features."""
    if alpha is None:
        alpha = _norm_alpha(df_state)
    x = torch.as_tensor(np.asarray(audio, np.float32), device=resolve_device(device))
    spec, erb, sf = _features(x, df_state, nb_df, alpha)
    return _ri(spec), erb, _ri(sf)


def _offline(model: DfModel, df_state: DfState, audio: np.ndarray, lim: float) -> np.ndarray:
    """The whole offline path on the model's device: STFT -> features ->
    forward -> attenuation-limit mix -> iDFT synthesis."""
    with span("enhance.h2d"):
        x = torch.from_numpy(np.ascontiguousarray(audio)).to(model.device)
    with span("enhance.features"):
        spec, erb, sf = _features(x, df_state, model.cfg["nb_df"], _norm_alpha(df_state))
        spec_ri = _ri(spec)
        sf_ri = _ri(sf)
    with span("enhance.forward"):
        (spec_e_ri, _, _, _), _ = model.module.forward(
            model.params, model.state, model.cfg, spec_ri, erb, sf_ri)
    with span("enhance.synthesis"):
        # attenuation-limit mixback (lim == 0 leaves spec_e)
        spec_e_ri = spec_ri * lim + spec_e_ri * (1.0 - lim)
        out = istft_ri(spec_e_ri, df_state.stft_cfg)
    with span("enhance.d2h"):  # waits for the device
        return out.cpu().numpy()


def enhance(
    model: DfModel,
    df_state: DfState,
    audio: np.ndarray,
    pad: bool = True,
    atten_lim_db: Optional[float] = None,
    backend: str = "offline",
    mesh=None,
) -> np.ndarray:
    """Enhance [C, T] float32 audio; returns the same shape when pad=True.

    Right-pads by n_fft, runs the model, and trims [d, orig_len + d] with
    d = n_fft - hop.

    backend:
      * "offline": the whole-utterance frame-parallel forward;
      * "scan": the per-frame StreamingRuntime (frame-exact vs "offline");
      * "auto": "scan" for batches of 16 rows or more, else "offline".

    mesh: a `parallel.Mesh`; the scan backend then splits the rows over its
    devices (weights copied to each, no traffic between them); the rows must
    divide over the devices.

    A call is the span `enhance` (utils/timings.py), with the children
    `enhance.pad`, `enhance.h2d`, `enhance.features`, `enhance.forward`,
    `enhance.synthesis`, `enhance.d2h` and `enhance.trim` on the offline
    path.
    """
    with span("enhance"):
        return _enhance(model, df_state, audio, pad, atten_lim_db, backend, mesh)


def _enhance(model, df_state, audio, pad, atten_lim_db, backend, mesh) -> np.ndarray:
    with span("enhance.pad"):
        audio = np.atleast_2d(np.asarray(audio, np.float32))
        orig_len = audio.shape[-1]
        n_fft, hop = df_state.fft_size, df_state.hop_size
        if pad:
            audio = np.pad(audio, ((0, 0), (0, n_fft)))
        # trim to whole hops (streaming analysis consumes whole frames only)
        t_hops = audio.shape[-1] // hop
        audio = audio[..., : t_hops * hop]
    lim = 0.0
    if atten_lim_db is not None and abs(atten_lim_db) > 0:
        lim = 10.0 ** (-abs(atten_lim_db) / 20.0)
    if backend == "auto":
        backend = "scan" if audio.shape[0] >= 16 else "offline"
    if backend == "offline":
        out = _offline(model, df_state, audio, lim)
    elif backend == "scan":
        rt = _get_scan_runtime(model, df_state, mesh)
        _, out = rt.process(rt.init(audio.shape[0]), audio)
        with span("enhance.d2h"):
            out = out.cpu().numpy()
        if lim > 0:
            # attenuation-limit mixback in the time domain: the spectral mix
            # lim*spec + (1-lim)*spec_e commutes with the linear synthesis,
            # and the synthesis of the unmodified spectrum is the input
            # delayed by d
            d = n_fft - hop
            delayed = np.zeros_like(out)
            delayed[:, d:] = audio[:, : out.shape[1] - d]
            out = lim * delayed + (1.0 - lim) * out
    else:
        raise ValueError(f"unknown backend {backend!r}")
    with span("enhance.trim"):
        if pad:
            d = n_fft - hop
            out = out[:, d : orig_len + d]
        return out


def _get_scan_runtime(model: DfModel, df_state: DfState, mesh=None):
    """One cached runtime per model (and mesh); atten_lim is applied by the
    caller."""
    from deepfilternet_torch.streaming import RuntimeParams, StreamingRuntime

    key = "scan_runtime" if mesh is None else ("scan_runtime", mesh)
    if key not in model._cache:
        if mesh is None:
            model._cache[key] = StreamingRuntime(model, df_state, RuntimeParams())
        else:
            from deepfilternet_torch.parallel.streams import ShardedStreamingRuntime

            model._cache[key] = ShardedStreamingRuntime(model, df_state, mesh)
    return model._cache[key]


# ---------------------------------------------------------------------------
# CLI: the JAX package's flags and output names, plus --device
# ---------------------------------------------------------------------------


DEFAULT_MODEL_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "pretrained", "dfn3_fixture_demo",
)


def main(args=None):
    parser = argparse.ArgumentParser(
        prog="deepFilter", description="Enhance noisy audio with DeepFilterNet (PyTorch)"
    )
    parser.add_argument("noisy_audio_files", nargs="*", help="WAV files to enhance")
    parser.add_argument("--noisy-dir", "-i", default=None,
                        help="Enhance every file in this directory instead of "
                             "listing noisy_audio_files")
    parser.add_argument("--model-base-dir", "-m", default=None,
                        help="Directory with config.ini and checkpoints/, or a "
                             ".tar.gz archive of one")
    parser.add_argument("--output-dir", "-o", default=".")
    parser.add_argument("--pf", action="store_true", help="Enable perceptual post-filter")
    parser.add_argument("--atten-lim", "-a", type=float, default=None,
                        help="Noise attenuation limit in dB")
    parser.add_argument("--no-delay-compensation", "-D", dest="compensate_delay",
                        action="store_false")
    parser.add_argument("--no-suffix", action="store_true")
    parser.add_argument("--no-df-stage", action="store_true",
                        help="Mask-only ablation: skip the deep-filtering "
                             "stage, output the ERB-masked spectrum")
    parser.add_argument("--epoch", "-e", default="best")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda; 'cpu' for the CPU)")
    args = parser.parse_args(args)
    if args.noisy_dir is not None:
        if args.noisy_audio_files:
            parser.error("pass either noisy_audio_files or --noisy-dir, not both")
        args.noisy_audio_files = sorted(
            os.path.join(args.noisy_dir, f) for f in os.listdir(args.noisy_dir)
            if os.path.isfile(os.path.join(args.noisy_dir, f))
        )
    if not args.noisy_audio_files:
        parser.error("no input files (pass WAV paths or --noisy-dir)")

    model_dir = args.model_base_dir
    if model_dir is None and os.path.isdir(DEFAULT_MODEL_DIR):
        model_dir = DEFAULT_MODEL_DIR
    model, df_state, suffix = init_df(
        model_dir, post_filter=args.pf, epoch=args.epoch,
        mask_only=args.no_df_stage, device=args.device,
    )
    os.makedirs(args.output_dir, exist_ok=True)
    for path in args.noisy_audio_files:
        audio, sr = load_audio(path)
        if sr != df_state.sr:
            audio = resample(audio, sr, df_state.sr)
        t0 = time.time()
        out = enhance(model, df_state, audio, pad=args.compensate_delay,
                      atten_lim_db=args.atten_lim)
        dt = time.time() - t0
        dur = audio.shape[-1] / df_state.sr
        print(f"Enhanced {path} in {dt:.2f}s (RTF: {dt / dur:.4f})")
        if sr != df_state.sr:
            out = resample(out, df_state.sr, sr)
        name = os.path.basename(path)
        # the JAX CLI's output names, so either package writes the same files
        if not args.no_suffix:
            stem, ext = os.path.splitext(name)
            name = f"{stem}_DeepFilterNet_TPU{ext}"
        save_audio(os.path.join(args.output_dir, name), out, sr)


if __name__ == "__main__":
    main()
