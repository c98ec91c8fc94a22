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

_NC = 128  # the kernel's DFT matrices are padded to a multiple of this many bins
_KS = 32  # K rows a slice of the kernel's ring: mem's and frame's rows are padded to it

# the kernel's two builds: (stream rows, bins) a block
_TILE_LARGE = (64, 64)
_TILE_SMALL = (16, 32)


def _frontend_tile(s: int, n_sm: int, fp: int = 512) -> Tuple[int, int]:
    """(stream rows, bins) a block for S streams on a card of n_sm
    multiprocessors: the large tile reads the DFT columns once for 64 streams,
    so it is taken as soon as its grid gives every multiprocessor a block;
    below that the small tile starts 8 times the blocks."""
    rows, bins = _TILE_LARGE
    return _TILE_LARGE if -(-s // rows) * (fp // bins) >= n_sm else _TILE_SMALL


def _frontend_scratch(s: int, tile: Tuple[int, int], fp: int, nb_erb: int):
    """Shapes of the kernel's scratch: each bin chunk's ERB band sums, and a
    zeroed done-counter per tile of streams (see the kernel's note)."""
    rows, bins = tile
    return (fp // bins, s, nb_erb), (-(-s // rows),)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's operand split, bit for bit: hi is x rounded to TF32's 10
    mantissa bits (half away from zero, on the bit pattern), lo = x - hi is
    exact in float32 and is cut to its upper 19 bits as the tensor core
    reads it. Used by the CPU tests to size the numerics; the kernel splits
    in registers."""
    bits = x.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    lo = ((x - hi).view(torch.int32) & ~0x1FFF).view(torch.float32)
    return hi, lo


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


def _k_rows(n: int) -> int:
    """Rows a source of n columns takes in the packed DFT: whole K-slices."""
    return -(-n // _KS) * _KS


@functools.lru_cache(maxsize=None)
def _packed_dft(fft_size: int, hop_size: int, bins: int, device: torch.device) -> torch.Tensor:
    """The padded DFT matrices as the kernel's build with `bins` bins a block
    reads them: [chunks, Dp + Hp, 2 * bins + 8], chunk c's K rows of
    [cos[:, c*bins:(c+1)*bins] | sin[...] | 8 floats of padding], so that a
    K-slice of a chunk is one contiguous copy in the layout (row stride 8
    off a multiple of 32 banks) its shared-memory loads want. The rows of
    mem (D = fft - hop) and of frame (H = hop) are each padded with zero rows
    to whole slices (Dp = _k_rows(D), Hp = _k_rows(H)), so that every slice
    comes from one of the two; at 960 / 480 there is no padding."""
    cos_p, sin_p = _padded_dft_tensors(fft_size, hop_size, device)
    n, fp = cos_p.shape
    d = fft_size - hop_size
    dp = _k_rows(d)
    chunks = fp // bins
    out = torch.zeros((chunks, dp + _k_rows(hop_size), 2 * bins + 8), dtype=torch.float32,
                      device=device)
    for lo, hi, at in ((0, d, 0), (d, n, dp)):
        for col, m in ((0, cos_p), (bins, sin_p)):
            out[:, at: at + hi - lo, col: col + bins] = (
                m[lo:hi].reshape(hi - lo, chunks, bins).permute(1, 0, 2))
    return out


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
    ragged last tile of streams, and the tile (64 streams x 64 bins a block,
    or 16 x 32 while that would leave multiprocessors idle) is chosen here
    from S and the card, so there is no `tile` argument. As for the TPU
    kernel, any fft_size >= hop_size > 0 works (the kernel masks the columns
    past the memory and the hop); the rest raises ValueError before a launch.
    """
    if hop_size <= 0 or fft_size < hop_size or nb_df > fft_size // 2 + 1:
        # what the TPU kernel cannot take either; any other fft / hop works
        raise ValueError(f"no analysis frontend for fft_size {fft_size}, hop_size {hop_size}, "
                         f"nb_df {nb_df}")
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
    fb = erb_fb_tensor(erb_widths(sr, fft_size, nb_erb, min_nb_erb_freqs), device)
    fp = -(-f // _NC) * _NC
    tile = _frontend_tile(s, _sm_count(device), fp)
    dft = _packed_dft(fft_size, hop_size, tile[1], device)
    band_shape, done_shape = _frontend_scratch(s, tile, fp, nb_erb)
    # one allocation for the eight outputs and the band-sum scratch (at S = 64
    # the host's per-tensor cost would otherwise exceed the kernel's time)
    widths = (d, f, f, nb_erb, nb_df, nb_df, nb_erb, nb_df, band_shape[0] * nb_erb)
    flat = torch.empty((s * sum(widths),), dtype=torch.float32, device=device)
    parts = flat.split([s * n for n in widths])
    outs = [t.view(s, n) for t, n in zip(parts[:8], widths)]
    band_part = parts[8]
    done = torch.zeros(done_shape, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.dfn_fused_frontend(
            *[t.data_ptr() for t in inputs],
            dft.data_ptr(), fb.data_ptr(),
            *[t.data_ptr() for t in outs],
            band_part.data_ptr(), done.data_ptr(),
            s, d, hop_size, f, fp, nb_erb, nb_df,
            float(alpha), float(1.0 - alpha), tile[0], stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_frontend kernel launch failed: cudaError {err}")
    fused_analysis_frontend.launches += 1
    return tuple(outs)


fused_analysis_frontend.launches = 0  # type: ignore[attr-defined]


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.dfn_fused_frontend
    fn.argtypes = [p] * 16 + [i] * 7 + [fl, fl, i, p]
    fn.restype = ctypes.c_int
    lib.dfn_empty_launch.argtypes = [p]
    lib.dfn_empty_launch.restype = ctypes.c_int
    return lib
