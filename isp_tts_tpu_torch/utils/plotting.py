"""Matplotlib figures of alignments and mels for the tracker (counterpart
of ``isp_tts_tpu/utils/plotting.py``). matplotlib is optional: it is
imported when a figure is drawn, never at import."""
from __future__ import annotations

import numpy as np


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_figure(data: dict[str, np.ndarray], title: str | None = None,
                origin: str = "lower", aspect: str = "auto"):
    """One row of imshow panels from a dict of 2-D arrays."""
    plt = _mpl()
    n = len(data)
    fig, axes = plt.subplots(1, n, figsize=(6 * n, 4), squeeze=False)
    for ax, (name, arr) in zip(axes[0], data.items()):
        im = ax.imshow(np.asarray(arr), origin=origin, aspect=aspect,
                       interpolation="none")
        ax.set_title(name)
        fig.colorbar(im, ax=ax)
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    return fig


def plot_attention(attn: dict[str, np.ndarray], title: str | None = None):
    """Attention maps (text x mel)."""
    return plot_figure(attn, title=title)


def plot_spectrogram(specs: dict[str, np.ndarray], title: str | None = None):
    """Mel spectrograms (mel_bins x frames)."""
    return plot_figure(specs, title=title)


def figure_to_array(fig) -> np.ndarray:
    """Render a figure to an (H, W, 3) uint8 array (for tensorboard)."""
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
    import matplotlib.pyplot as plt

    plt.close(fig)
    return buf.copy()
