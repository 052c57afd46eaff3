"""Classification metrics in numpy (own copy of ``audax/eval/metrics.py``).

Accuracy, macro/weighted/per-class precision/recall/F1 (zero division ->
0, sklearn's convention), the confusion matrix, the text classification
report, and a row-normalized confusion-matrix plot (matplotlib, imported
only when a plot is asked for).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

__all__ = ["confusion_matrix", "detailed_metrics", "classification_report",
           "plot_confusion_matrix", "URBANSOUND8K_CLASSES"]

URBANSOUND8K_CLASSES = (
    "air_conditioner", "car_horn", "children_playing", "dog_bark", "drilling",
    "engine_idling", "gun_shot", "jackhammer", "siren", "street_music",
)


def confusion_matrix(y_true: np.ndarray, y_pred: np.ndarray,
                     num_classes: int) -> np.ndarray:
    """cm[i, j] = count of true class i predicted as j."""
    y_true = np.asarray(y_true, dtype=np.int64)
    y_pred = np.asarray(y_pred, dtype=np.int64)
    for name, y in (("y_true", y_true), ("y_pred", y_pred)):
        if y.size and (y.min() < 0 or y.max() >= num_classes):
            # np.add.at would wrap a negative label into the last class
            raise ValueError(f"{name} labels outside [0, {num_classes}): "
                             f"min {y.min()}, max {y.max()}")
    cm = np.zeros((num_classes, num_classes), dtype=np.int64)
    np.add.at(cm, (y_true, y_pred), 1)
    return cm


def detailed_metrics(y_true: np.ndarray, y_pred: np.ndarray,
                     num_classes: int) -> Dict[str, object]:
    """Accuracy + per-class/macro/weighted P/R/F1."""
    cm = confusion_matrix(y_true, y_pred, num_classes)
    tp = np.diag(cm).astype(np.float64)
    support = cm.sum(axis=1).astype(np.float64)          # true counts
    predicted = cm.sum(axis=0).astype(np.float64)        # predicted counts
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(predicted > 0, tp / predicted, 0.0)
        recall = np.where(support > 0, tp / support, 0.0)
        denom = precision + recall
        f1 = np.where(denom > 0, 2 * precision * recall / denom, 0.0)
    total = max(cm.sum(), 1)
    wsum = max(support.sum(), 1.0)
    return {
        "accuracy": float(tp.sum() / total),
        "precision_per_class": precision,
        "recall_per_class": recall,
        "f1_per_class": f1,
        "support": support.astype(np.int64),
        "precision_macro": float(precision.mean()),
        "recall_macro": float(recall.mean()),
        "f1_macro": float(f1.mean()),
        "precision_weighted": float((precision * support).sum() / wsum),
        "recall_weighted": float((recall * support).sum() / wsum),
        "f1_weighted": float((f1 * support).sum() / wsum),
        "confusion_matrix": cm,
    }


def classification_report(y_true: np.ndarray, y_pred: np.ndarray,
                          class_names: Sequence[str]) -> str:
    m = detailed_metrics(y_true, y_pred, len(class_names))
    width = max(len(n) for n in class_names) + 2
    lines = [f"{'':<{width}}{'prec':>8}{'recall':>8}{'f1':>8}{'support':>9}"]
    for i, name in enumerate(class_names):
        lines.append(
            f"{name:<{width}}{m['precision_per_class'][i]:>8.3f}"
            f"{m['recall_per_class'][i]:>8.3f}{m['f1_per_class'][i]:>8.3f}"
            f"{int(m['support'][i]):>9d}")
    lines.append("")
    lines.append(f"{'accuracy':<{width}}{'':>16}{m['accuracy']:>8.3f}"
                 f"{int(m['support'].sum()):>9d}")
    for avg in ("macro", "weighted"):
        lines.append(
            f"{avg + ' avg':<{width}}{m['precision_' + avg]:>8.3f}"
            f"{m['recall_' + avg]:>8.3f}{m['f1_' + avg]:>8.3f}"
            f"{int(m['support'].sum()):>9d}")
    return "\n".join(lines)


def plot_confusion_matrix(
    y_true: np.ndarray, y_pred: np.ndarray, class_names: Sequence[str],
    path: Optional[str] = None, title: str = "Confusion matrix",
):
    """Row-normalized confusion-matrix heatmap with per-class n in the
    labels. With ``path`` the figure is saved and closed (returns None);
    without it the live figure is returned."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cm = confusion_matrix(y_true, y_pred, len(class_names))
    row = cm.sum(axis=1, keepdims=True)
    norm = np.where(row > 0, cm / np.maximum(row, 1), 0.0)
    labels = [f"{n}\n(n={int(c)})" for n, c in zip(class_names, cm.sum(axis=1))]

    fig, ax = plt.subplots(figsize=(10, 8))
    im = ax.imshow(norm, vmin=0.0, vmax=1.0, cmap="Blues")
    ax.set_xticks(range(len(class_names)), class_names, rotation=45, ha="right")
    ax.set_yticks(range(len(class_names)), labels)
    for i in range(len(class_names)):
        for j in range(len(class_names)):
            ax.text(j, i, f"{norm[i, j]:.2f}", ha="center", va="center",
                    color="white" if norm[i, j] > 0.5 else "black", fontsize=8)
    ax.set_xlabel("Predicted")
    ax.set_ylabel("True")
    ax.set_title(title)
    fig.colorbar(im)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
        plt.close(fig)
        return None
    return fig
