"""Fused streaming analysis frontend: one kernel per frame for S streams.

    buf      = [analysis_mem | frame]
    spec     = buf @ windowed-DFT (re, im)
    power    = re^2 + im^2
    erb      = 10*log10(power @ erb_fb + 1e-10)
    mean_s'  = (1-a)*erb + a*mean_s,        feat_erb = (erb - mean_s') / 40
    unit_s'  = (1-a)*sqrt(power_lo) + a*unit_s,  feat_c = spec_lo * rsqrt(unit_s')

Port of the TPU kernel `deepfilternet_tpu/ops/pallas_frontend.py`
(`fused_analysis_frontend` / `_kernel`). The CUDA kernel is
`csrc/fused_frontend.cu`; `fused_analysis_frontend_plain` is the same
function in plain PyTorch (the per-frame frontend of the JAX runtime's jnp
path). `fused_analysis_frontend` runs the plain version for tensors on the
CPU and launches the kernel for tensors on a CUDA device; it never falls
back from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from deepfilternet_torch.ops.erb import erb_fb_tensor, erb_widths
from deepfilternet_torch.ops.norms import erb_norm_step
from deepfilternet_torch.ops.stft import Stft, analysis_step_ri, dft_matrices

_NC = 128  # bins per kernel block; its DFT matrices are padded to a multiple


@functools.lru_cache(maxsize=None)
def _padded_dft_tensors(fft_size: int, hop_size: int, device: torch.device):
    f = fft_size // 2 + 1
    fp = -(-f // _NC) * _NC
    out = []
    for m in dft_matrices(fft_size, hop_size):
        pad = np.zeros((fft_size, fp), np.float32)
        pad[:, :f] = m
        out.append(torch.tensor(pad, device=device))
    return tuple(out)


def fused_analysis_frontend_plain(
    analysis_mem: torch.Tensor,
    frame: torch.Tensor,
    mean_state: torch.Tensor,
    unit_state: torch.Tensor,
    *,
    fft_size: int = 960,
    hop_size: int = 480,
    nb_erb: int = 32,
    nb_df: int = 96,
    min_nb_erb_freqs: int = 2,
    alpha: float = 0.99,
    sr: int = 48000,
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the kernel; same arguments and outputs."""
    stft_cfg = Stft(sr=sr, fft_size=fft_size, hop_size=hop_size)
    fb = erb_fb_tensor(erb_widths(sr, fft_size, nb_erb, min_nb_erb_freqs), analysis_mem.device)
    amem, re, im = analysis_step_ri(analysis_mem, frame, stft_cfg)
    power = re**2 + im**2
    erb_db = 10.0 * torch.log10(power @ fb + 1e-10)
    mn, feat_erb = erb_norm_step(mean_state, erb_db, alpha)
    mag_lo = torch.sqrt(power[..., :nb_df])
    un = mag_lo * (1.0 - alpha) + unit_state * alpha
    scale = torch.rsqrt(un)
    return amem, re, im, feat_erb, re[..., :nb_df] * scale, im[..., :nb_df] * scale, mn, un


def _check_inputs(analysis_mem, frame, mean_state, unit_state, fft_size, hop_size,
                  nb_erb, nb_df):
    s = analysis_mem.shape[0]
    want = {
        "analysis_mem": (analysis_mem, (s, fft_size - hop_size)),
        "frame": (frame, (s, hop_size)),
        "mean_state": (mean_state, (s, nb_erb)),
        "unit_state": (unit_state, (s, nb_df)),
    }
    for name, (t, shape) in want.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if t.device != analysis_mem.device:
            raise ValueError(f"{name} is on {t.device}, analysis_mem on {analysis_mem.device}")


def fused_analysis_frontend(
    analysis_mem: torch.Tensor,  # [S, fft-hop]
    frame: torch.Tensor,         # [S, hop]
    mean_state: torch.Tensor,    # [S, E]
    unit_state: torch.Tensor,    # [S, F']
    *,
    fft_size: int = 960,
    hop_size: int = 480,
    nb_erb: int = 32,
    nb_df: int = 96,
    min_nb_erb_freqs: int = 2,
    alpha: float = 0.99,
    sr: int = 48000,
) -> Tuple[torch.Tensor, ...]:
    """Returns (new_mem, spec_re, spec_im, feat_erb, fc_re, fc_im,
    new_mean_state, new_unit_state), all float32.

    CPU tensors run the plain version; CUDA tensors launch the kernel (and
    count one launch in `fused_analysis_frontend.launches`) or raise. Unlike
    the TPU kernel, any number of streams S works: the CUDA kernel masks its
    ragged last tile of 32 streams, so there is no `tile` argument.
    """
    _check_inputs(analysis_mem, frame, mean_state, unit_state, fft_size, hop_size,
                  nb_erb, nb_df)
    kw = dict(fft_size=fft_size, hop_size=hop_size, nb_erb=nb_erb, nb_df=nb_df,
              min_nb_erb_freqs=min_nb_erb_freqs, alpha=alpha, sr=sr)
    device = analysis_mem.device
    if device.type == "cpu":
        return fused_analysis_frontend_plain(analysis_mem, frame, mean_state, unit_state, **kw)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    from deepfilternet_torch.kernels import load

    lib = _bind(load("fused_frontend"))
    inputs = (analysis_mem, frame, mean_state, unit_state)
    if not all(t.is_contiguous() for t in inputs):
        raise ValueError("the fused frontend kernel needs contiguous inputs")
    s = analysis_mem.shape[0]
    d, f = fft_size - hop_size, fft_size // 2 + 1
    cos_p, sin_p = _padded_dft_tensors(fft_size, hop_size, device)
    fb = erb_fb_tensor(erb_widths(sr, fft_size, nb_erb, min_nb_erb_freqs), device)
    fp = cos_p.shape[1]
    outs = [torch.empty((s, n), dtype=torch.float32, device=device)
            for n in (d, f, f, nb_erb, nb_df, nb_df, nb_erb, nb_df)]
    # scratch: each bin chunk's ERB band sums, and a zeroed done-counter per
    # tile of 32 streams (see the kernel's note)
    band_part = torch.empty((fp // _NC, s, nb_erb), dtype=torch.float32, device=device)
    done = torch.zeros((-(-s // 32),), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.dfn_fused_frontend(
            *[t.data_ptr() for t in inputs],
            cos_p.data_ptr(), sin_p.data_ptr(), fb.data_ptr(),
            *[t.data_ptr() for t in outs],
            band_part.data_ptr(), done.data_ptr(),
            s, d, hop_size, f, fp, nb_erb, nb_df,
            float(alpha), float(1.0 - alpha), stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_frontend kernel launch failed: cudaError {err}")
    fused_analysis_frontend.launches += 1
    return tuple(outs)


fused_analysis_frontend.launches = 0  # type: ignore[attr-defined]


@functools.lru_cache(maxsize=None)
def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.dfn_fused_frontend
    fn.argtypes = [p] * 17 + [i] * 7 + [fl, fl, p]
    fn.restype = ctypes.c_int
    return lib
