"""User-facing enhancement API.

  * `init_df(model_base_dir, ...)` -> (model, df_state, suffix)
  * `enhance(model, df_state, audio, pad=True, atten_lim_db=None, backend=...)`

The model is a (params, state, cfg, module) bundle on one device. Entry
points run on the CUDA device unless the caller passes `device="cpu"`; with
no GPU present they raise instead of falling back to the CPU. Delay
compensation pads by n_fft and trims d = n_fft - hop, as in the JAX package.

Not ported yet: the offline forward (`backend="offline"`), the CLI and
model artifact archives (`.tar.gz`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from deepfilternet_torch.checkpoint import params_from_numpy, read_cp
from deepfilternet_torch.config import config
from deepfilternet_torch.models import init_model
from deepfilternet_torch.ops.erb import erb_widths
from deepfilternet_torch.ops.stft import Stft


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

    `model_base_dir` holds `config.ini` and a `checkpoints/` dir; without it
    the live config is used with randomly initialized weights.
    """
    dev = resolve_device(device)
    if model_base_dir is not None and model_base_dir.endswith((".tar.gz", ".tgz")):
        raise NotImplementedError("model archives are not ported yet; unpack it first")
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
      * "scan": the per-frame StreamingRuntime;
      * "auto": "scan" for batches of 16 rows or more, else "offline";
      * "offline": the whole-utterance forward, not ported yet (raises).

    mesh: stream sharding over several devices is not ported yet; must be None.
    """
    if mesh is not None:
        raise NotImplementedError("stream sharding over a mesh is not ported yet")
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
        raise NotImplementedError(
            "the offline forward is not ported yet (ROADMAP); use backend='scan'"
        )
    if backend != "scan":
        raise ValueError(f"unknown backend {backend!r}")
    rt = _get_scan_runtime(model, df_state)
    _, out = rt.process(rt.init(audio.shape[0]), audio)
    out = out.cpu().numpy()
    if lim > 0:
        # attenuation-limit mixback in the time domain: the spectral mix
        # lim*spec + (1-lim)*spec_e commutes with the linear synthesis, and
        # the synthesis of the unmodified spectrum is the input delayed by d
        d = n_fft - hop
        delayed = np.zeros_like(out)
        delayed[:, d:] = audio[:, : out.shape[1] - d]
        out = lim * delayed + (1.0 - lim) * out
    if pad:
        d = n_fft - hop
        out = out[:, d : orig_len + d]
    return out


def _get_scan_runtime(model: DfModel, df_state: DfState):
    """One cached runtime per model; atten_lim is applied by the caller."""
    from deepfilternet_torch.streaming import RuntimeParams, StreamingRuntime

    if "scan_runtime" not in model._cache:
        model._cache["scan_runtime"] = StreamingRuntime(model, df_state, RuntimeParams())
    return model._cache["scan_runtime"]
