"""Training and synthesis plots: alignments, spectrograms, waveforms.

Counterpart of tacotron2_tpu/utils/plot.py (reference tacotron/utils/
plot.py:16-77, wavenet_vocoder/util.py:174-233). matplotlib is imported
inside each call, headless (Agg); where it does not import, the call logs
one line and returns without writing (`pyplot` returns None).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from . import log


def pyplot(path: str):
    """matplotlib.pyplot on the Agg backend, or None (with a logged line
    naming the plot not written) where matplotlib does not import."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        log(f"plot skipped, matplotlib is not installed: {path}")
        return None
    return plt


def split_title_line(title_text: str, max_words: int = 5) -> str:
    seq = title_text.split()
    return "\n".join(" ".join(seq[i:i + max_words])
                     for i in range(0, len(seq), max_words))


def plot_alignment(alignment, path: str, title: Optional[str] = None) -> bool:
    """alignment [T_in, decoder steps] as a heatmap (reference
    plot.py:16-37); True when written."""
    plt = pyplot(path)
    if plt is None:
        return False
    alignment = np.asarray(alignment)
    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_subplot(111)
    im = ax.imshow(alignment, aspect="auto", origin="lower",
                   interpolation="none")
    fig.colorbar(im, ax=ax)
    plt.xlabel("Decoder timestep")
    plt.ylabel("Encoder timestep")
    if title is not None:
        plt.title(split_title_line(title))
    plt.tight_layout()
    plt.savefig(path, format="png")
    plt.close(fig)
    return True


def plot_spectrogram(pred_spectrogram, path: str, title: Optional[str] = None,
                     target_spectrogram=None) -> bool:
    """The predicted (and target) spectrogram [frames, bins] (reference
    plot.py:40-77); True when written."""
    plt = pyplot(path)
    if plt is None:
        return False
    pred_spectrogram = np.asarray(pred_spectrogram)
    fig = plt.figure(figsize=(10, 8))
    panels = [(pred_spectrogram, None)]
    if target_spectrogram is not None:
        panels = [(np.asarray(target_spectrogram), "Target Mel-Spectrogram"),
                  (pred_spectrogram, "Predicted Mel-Spectrogram")]
    for i, (spec, name) in enumerate(panels):
        ax = fig.add_subplot(len(panels), 1, i + 1)
        im = ax.imshow(np.rot90(spec), aspect="auto", interpolation="none")
        if name:
            ax.set_title(name)
        fig.colorbar(im, ax=ax)
    if title is not None:
        fig.suptitle(split_title_line(title))
    plt.tight_layout()
    plt.savefig(path, format="png")
    plt.close(fig)
    return True


def waveplot(path: str, y_hat, y_target, sample_rate: int) -> bool:
    """Generated (and target) waveform panels (reference util.py:174-233);
    True when written."""
    plt = pyplot(path)
    if plt is None:
        return False
    fig = plt.figure(figsize=(12, 4))
    panels = [(y_hat, "Generated waveform")]
    if y_target is not None:
        panels = [(y_target, "Target waveform"),
                  (y_hat, "Predicted waveform")]
    for i, (y, name) in enumerate(panels):
        ax = plt.subplot(len(panels), 1, i + 1)
        ax.plot(np.asarray(y))
        ax.set_title(name)
    plt.tight_layout()
    plt.savefig(path, format="png")
    plt.close(fig)
    return True
