"""Sample visualizations: waveform + spectrogram PNGs (the port's own
copy of ``audax/eval/plots.py``; matplotlib is imported when a figure is
drawn, not with the module).

Reproduces the reference's inspection artifacts (reference:
.charles/spectrogram.py:242-362): a dual-pane figure of the raw waveform and
its log-mel spectrogram with the fixed classification window marked.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["plot_waveform", "plot_spectrogram", "plot_sample"]


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_waveform(x: np.ndarray, sample_rate: int, path: Optional[str] = None,
                  window_s: Optional[float] = None, title: str = "Waveform"):
    plt = _plt()
    t = np.arange(len(x)) / sample_rate
    fig, ax = plt.subplots(figsize=(12, 3))
    ax.plot(t, x, linewidth=0.4)
    if window_s is not None:
        ax.axvspan(0, min(window_s, t[-1] if len(t) else 0), alpha=0.15,
                   color="tab:orange", label=f"{window_s:.1f}s window")
        ax.legend(loc="upper right")
    ax.set_xlabel("time [s]")
    ax.set_ylabel("amplitude")
    ax.set_title(title)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
        plt.close(fig)
    return fig


def plot_spectrogram(mel: np.ndarray, sample_rate: int, hop_length: int,
                     path: Optional[str] = None, window_s: Optional[float] = None,
                     title: str = "Log-mel spectrogram"):
    """mel: [n_mels, T] (mel-first layout, as the reference stores it)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(12, 4))
    extent = [0, mel.shape[1] * hop_length / sample_rate, 0, mel.shape[0]]
    im = ax.imshow(mel, aspect="auto", origin="lower", extent=extent,
                   cmap="magma")
    if window_s is not None:
        ax.axvline(window_s, color="cyan", linestyle="--",
                   label=f"{window_s:.1f}s window")
        ax.legend(loc="upper right")
    ax.set_xlabel("time [s]")
    ax.set_ylabel("mel bin")
    ax.set_title(title)
    fig.colorbar(im, label="log power")
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
        plt.close(fig)
    return fig


def plot_sample(x: np.ndarray, mel: np.ndarray, sample_rate: int,
                hop_length: int, path: str, window_s: Optional[float] = None,
                title: str = ""):
    """Dual-pane waveform + spectrogram figure (the reference's sample PNGs)."""
    plt = _plt()
    fig, (ax0, ax1) = plt.subplots(2, 1, figsize=(12, 7),
                                   height_ratios=[1, 2])
    t = np.arange(len(x)) / sample_rate
    ax0.plot(t, x, linewidth=0.4)
    ax0.set_ylabel("amplitude")
    ax0.set_title(title or "sample")
    extent = [0, mel.shape[1] * hop_length / sample_rate, 0, mel.shape[0]]
    im = ax1.imshow(mel, aspect="auto", origin="lower", extent=extent,
                    cmap="magma")
    if window_s is not None:
        for ax in (ax0, ax1):
            ax.axvline(window_s, color="cyan", linestyle="--")
    ax1.set_xlabel("time [s]")
    ax1.set_ylabel("mel bin")
    fig.colorbar(im, ax=ax1, label="log power")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path
