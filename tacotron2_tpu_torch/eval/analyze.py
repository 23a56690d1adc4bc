"""Result analysis: discriminator confusion matrices, embedding plots.

Counterpart of tacotron2_tpu/eval/analyze.py (reference
single_use/analyze_results.py:41-91, spk_disc test_disc): the confusion
matrix of a discriminator's predictions and its normalised heatmap, the
classification of mels by a `disc.model.DiscriminatorModel`, a PCA scatter
of style embeddings by class, and the embedding TSV export. The plots
import matplotlib inside the call (`utils/plot.pyplot`) and are skipped,
with a logged line, where it does not import.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..utils.plot import pyplot


def confusion_matrix(labels: Sequence[int], preds: Sequence[int],
                     n_classes: Optional[int] = None) -> np.ndarray:
    """[n_classes, n_classes] counts: rows true, columns predicted."""
    labels = np.asarray(labels, np.int64)
    preds = np.asarray(preds, np.int64)
    n = n_classes or int(max(labels.max(), preds.max())) + 1
    cm = np.zeros((n, n), np.int64)
    np.add.at(cm, (labels, preds), 1)
    return cm


def plot_confusion_matrix(cm: np.ndarray, path: str, class_names=None,
                          title: str = "Confusion matrix",
                          normalize: bool = True) -> np.ndarray:
    """The row-normalised heatmap with counts (analyze_results.py:41-64);
    returns the displayed matrix, written or not."""
    display = cm.astype(np.float64)
    if normalize:
        display = display / np.maximum(display.sum(axis=1, keepdims=True), 1)
    plt = pyplot(path)
    if plt is None:
        return display
    n = cm.shape[0]
    names = class_names or [str(i) for i in range(n)]
    fig, ax = plt.subplots(figsize=(1.2 * n + 2, 1.2 * n + 1.5))
    im = ax.imshow(display, cmap="Blues", vmin=0,
                   vmax=1 if normalize else None)
    fig.colorbar(im, ax=ax)
    ax.set_xticks(range(n))
    ax.set_xticklabels(names, rotation=45)
    ax.set_yticks(range(n))
    ax.set_yticklabels(names)
    for i in range(n):
        for j in range(n):
            ax.text(j, i, f"{cm[i, j]}", ha="center", va="center",
                    color="white" if display[i, j] > 0.5 else "black")
    ax.set_xlabel("Predicted")
    ax.set_ylabel("True")
    ax.set_title(title)
    plt.tight_layout()
    plt.savefig(path)
    plt.close(fig)
    return display


@torch.no_grad()
def classify_mels(disc_model, mels: Sequence[np.ndarray],
                  crop_frames: int = 128) -> np.ndarray:
    """Predicted class ids of each mel [T, num_mels] by a discriminator
    with a CE head (eval mode), each cropped to `crop_frames` and padded
    with -4 (JAX `classify_mels`)."""
    device = next(disc_model.parameters()).device
    preds = []
    for mel in mels:
        if len(mel) < crop_frames:
            mel = np.pad(mel, ((0, crop_frames - len(mel)), (0, 0)),
                         constant_values=-4.0)
        x = torch.as_tensor(np.asarray(mel[None, :crop_frames], np.float32),
                            device=device)
        _, logits = disc_model(x, train=False)
        preds.append(int(logits[0].argmax()))
    return np.asarray(preds)


def plot_embedding_clusters(embeddings: np.ndarray, labels: Sequence[int],
                            path: str, title: str = "Style embeddings",
                            method: str = "pca") -> np.ndarray:
    """The 2-D PCA projection of the embeddings, scattered by class
    (analyze_results.py:66-91); returns the projection, written or not."""
    X = np.asarray(embeddings, np.float64)
    X = X - X.mean(axis=0)
    _, _, vt = np.linalg.svd(X, full_matrices=False)
    proj = X @ vt[:2].T
    plt = pyplot(path)
    if plt is None:
        return proj
    labels = np.asarray(labels)
    fig, ax = plt.subplots(figsize=(7, 6))
    for c in np.unique(labels):
        pts = proj[labels == c]
        ax.scatter(pts[:, 0], pts[:, 1], label=str(c), s=18, alpha=0.75)
    ax.legend(title="class")
    ax.set_title(title)
    plt.tight_layout()
    plt.savefig(path)
    plt.close(fig)
    return proj


def export_style_embeddings_tsv(embeddings: np.ndarray, metadata_rows,
                                out_dir: str, prefix: str = "style_embs"):
    """Embedding and metadata TSVs (reference synthesize.py 'style_embs')."""
    os.makedirs(out_dir, exist_ok=True)
    emb_path = os.path.join(out_dir, f"{prefix}.tsv")
    meta_path = os.path.join(out_dir, f"{prefix}_meta.tsv")
    np.savetxt(emb_path, np.asarray(embeddings), delimiter="\t", fmt="%.6f")
    with open(meta_path, "w", encoding="utf-8") as f:
        for row in metadata_rows:
            f.write("\t".join(str(x) for x in row) + "\n")
    return emb_path, meta_path
