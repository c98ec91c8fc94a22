"""Spectrogram visualization (reference: df/visualization.py:8-128), as in
`deepfilternet_tpu.utils.visualization`. matplotlib is imported when a
figure is drawn, so the module imports where matplotlib is absent."""

from __future__ import annotations

from typing import Optional

import numpy as np


def spec_figure(
    spec: np.ndarray,
    sr: int = 48000,
    hop: int = 480,
    title: Optional[str] = None,
    path: Optional[str] = None,
    vmin: float = -100.0,
    vmax: float = 0.0,
):
    """Render a [T, F] (complex or dB) spectrogram to a matplotlib figure;
    saves to `path` when given. Returns the figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if np.iscomplexobj(spec):
        spec = 20 * np.log10(np.abs(spec) + 1e-12)
    fig, ax = plt.subplots(figsize=(10, 4))
    t = spec.shape[0] * hop / sr
    im = ax.imshow(
        spec.T, origin="lower", aspect="auto", vmin=vmin, vmax=vmax,
        extent=(0, t, 0, sr / 2 / 1000), cmap="inferno",
    )
    ax.set_xlabel("time [s]")
    ax.set_ylabel("frequency [kHz]")
    if title:
        ax.set_title(title)
    fig.colorbar(im, ax=ax, label="dB")
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=100)
        plt.close(fig)
    return fig
