"""Evaluation loops + metric registry (reference: df/evaluation_utils.py),
the port's copy of `deepfilternet_tpu.eval.evaluation`.

`evaluation_loop(model, df_state, noisy_files, clean_files)` enhances each
file with the port's `enhance` (on the model's device) and computes the
configured metrics in a process pool (metric math is NumPy/CPU-bound),
returning per-file and mean results with optional CSV export — the same
workflow as the reference's evaluation_loop/Metric tree. The pool's
workers are spawned, not forked: the parent holds a CUDA context and
torch's threads, and a forked child of a threaded process may deadlock.
The workers import numpy and scipy only and get numpy arrays, never
tensors.

Metrics: stoi, sisdr, snrseg, fwsnrseg, llr, wss, pesq, pesq-nb, composite,
dnsmos (gated: requires onnxruntime + model files, neither vendored here).
PESQ uses the ITU `pesq` wheel when installed, else the from-spec NumPy
implementation in eval/pesq.py.
"""

from __future__ import annotations

import csv as csv_mod
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from deepfilternet_torch.eval import sepm
from deepfilternet_torch.eval.stoi import stoi
from deepfilternet_torch.utils.audio_io import load_audio, resample


def si_sdr_np(estimate: np.ndarray, target: np.ndarray) -> float:
    """Scale-invariant SDR in dB (df/loss.py:345-373 semantics)."""
    e = estimate.reshape(-1).astype(np.float64)
    t = target.reshape(-1).astype(np.float64)
    eps = np.finfo(np.float32).eps
    a = (np.dot(t, e) + eps) / (np.dot(t, t) + eps)
    e_true = a * t
    e_res = e - e_true
    return float(10 * np.log10((np.sum(e_true**2) + eps) / (np.sum(e_res**2) + eps)))


def _to_16k(x: np.ndarray, sr: int) -> np.ndarray:
    if sr == 16000:
        return x
    return resample(x[None].astype(np.float32), sr, 16000)[0]


def compute_metrics(
    clean: np.ndarray,
    enhanced: np.ndarray,
    sr: int,
    metrics: Sequence[str] = ("stoi", "sisdr", "snrseg", "composite"),
) -> Dict[str, float]:
    out: Dict[str, float] = {}
    n = min(len(clean), len(enhanced))
    clean, enhanced = clean[:n], enhanced[:n]
    if "stoi" in metrics:
        out["stoi"] = stoi(clean, enhanced, sr)
    if "sisdr" in metrics:
        out["sisdr"] = si_sdr_np(enhanced, clean)
    c16 = e16 = None
    # the JAX package leaves out "pesq" and "pesq-nb" here, so either alone
    # reaches PESQ with no signal and raises
    if any(m in metrics for m in ("snrseg", "fwsnrseg", "llr", "wss", "pesq", "pesq-nb",
                                  "composite")):
        c16, e16 = _to_16k(clean, sr), _to_16k(enhanced, sr)
    if "snrseg" in metrics:
        out["snrseg"] = sepm.snr_seg(c16, e16, 16000)
    if "fwsnrseg" in metrics:
        out["fwsnrseg"] = sepm.fw_snr_seg(c16, e16, 16000)
    if "llr" in metrics:
        out["llr"] = sepm.llr(c16, e16, 16000)
    if "wss" in metrics:
        out["wss"] = sepm.wss(c16, e16, 16000)
    if "pesq" in metrics:
        from deepfilternet_torch.eval.pesq import pesq as _pesq

        out["pesq_wb"] = _pesq(16000, c16, e16, "wb")
    if "pesq-nb" in metrics:
        from deepfilternet_torch.eval.pesq import pesq as _pesq

        c8 = resample(c16[None].astype(np.float32), 16000, 8000)[0]
        e8 = resample(e16[None].astype(np.float32), 16000, 8000)[0]
        out["pesq_nb"] = _pesq(8000, c8, e8, "nb")
    if "composite" in metrics:
        pesq_mos, csig, cbak, covl, segsnr = sepm.composite(c16, e16, 16000)
        out.update(pesq=pesq_mos, csig=csig, cbak=cbak, covl=covl,
                   composite_segsnr=segsnr)
    if "dnsmos" in metrics:
        out.update(dnsmos(enhanced, sr))
    return out


def dnsmos(audio: np.ndarray, sr: int) -> Dict[str, float]:
    """DNSMOS P.835/P.808 (reference: df/scripts/dnsmos*.py) requires the
    Microsoft ONNX models plus onnxruntime; neither is vendored in this
    zero-egress environment."""
    raise RuntimeError(
        "DNSMOS needs onnxruntime and the sig_bak_ovr.onnx/model_v8.onnx "
        "weights; place them under $DNSMOS_DIR and install onnxruntime to "
        "enable (see df/scripts/dnsmos.py in the reference)."
    )


def _eval_one(args) -> Tuple[str, Dict[str, float]]:
    name, clean_path, enh, sr, metrics = args
    clean, csr = load_audio(clean_path)
    if csr != sr:
        clean = resample(clean, csr, sr)
    return name, compute_metrics(clean[0], enh[0] if enh.ndim > 1 else enh, sr, metrics)


def evaluation_loop(
    model,
    df_state,
    noisy_files: Sequence[str],
    clean_files: Sequence[str],
    metrics: Sequence[str] = ("stoi", "sisdr", "snrseg"),
    n_workers: int = 4,
    csv_path: Optional[str] = None,
    enhance_fn: Optional[Callable] = None,
) -> Dict[str, float]:
    """Enhance noisy files, compare against clean, aggregate metric means.

    The model runs where it was loaded (`init_df(..., device=...)`); the
    default `enhance_fn` is the port's `enhance` (offline backend)."""
    from deepfilternet_torch.enhance import enhance as _enhance

    enhance_fn = enhance_fn or (lambda audio: _enhance(model, df_state, audio))
    jobs = []
    for noisy_path, clean_path in zip(noisy_files, clean_files):
        audio, sr = load_audio(noisy_path)
        if sr != df_state.sr:
            audio = resample(audio, sr, df_state.sr)
        enh = enhance_fn(audio)
        jobs.append((os.path.basename(noisy_path), clean_path, np.asarray(enh),
                     df_state.sr, tuple(metrics)))

    results: List[Tuple[str, Dict[str, float]]] = []
    if n_workers > 1 and len(jobs) > 1:
        with ProcessPoolExecutor(max_workers=n_workers,
                                 mp_context=multiprocessing.get_context("spawn")) as pool:
            results = list(pool.map(_eval_one, jobs))
    else:
        results = [_eval_one(j) for j in jobs]

    if csv_path:
        keys = sorted({k for _, m in results for k in m})
        with open(csv_path, "w", newline="") as f:
            w = csv_mod.writer(f)
            w.writerow(["file"] + keys)
            for name, m in results:
                w.writerow([name] + [m.get(k, "") for k in keys])

    means: Dict[str, float] = {}
    for _, m in results:
        for k, v in m.items():
            means.setdefault(k, []).append(v)  # type: ignore[arg-type]
    nan_metrics = sorted(k for k, v in means.items() if np.isnan(v).any())
    if nan_metrics:
        from deepfilternet_torch.utils.logger import warn_once

        warn_once(
            f"metrics with NaN entries excluded from means: {nan_metrics} "
            "(a fully-NaN column means the metric is unavailable, e.g. "
            "DNSMOS without onnxruntime/models)"
        )
    return {k: float(np.nanmean(v)) for k, v in means.items()}
