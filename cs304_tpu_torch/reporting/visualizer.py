"""Confusion-matrix and line plots (reference visualizer.py).

Adds on top of the reference: the confusion matrix is computed as a reusable
array function (the reference inlines it into the plot, visualizer.py:19-25),
plots take an explicit output directory instead of hardcoding ./plots, and
matplotlib is imported lazily so headless library use never pays for it.
"""
from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np


def confusion_matrix(
    predictions: Sequence[str], ground_truth: Sequence[str], class_names: List[str]
) -> np.ndarray:
    """Counts[true, pred] (reference visualizer.py:19-25)."""
    n = len(class_names)
    index = {c: i for i, c in enumerate(class_names)}
    cm = np.zeros((n, n), np.int64)
    for truth, pred in zip(ground_truth, predictions):
        cm[index[truth], index[pred]] += 1
    return cm


def plot_confusion_matrix_from_lists(
    predictions: Sequence[str],
    ground_truth: Sequence[str],
    class_names: List[str],
    title: str = "Confusion Matrix",
    figsize=(8, 6),
    out_dir: str = "./plots",
) -> str:
    """Heatmap with per-cell counts (reference visualizer.py:6-45)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cm = confusion_matrix(predictions, ground_truth, class_names)
    n = len(class_names)
    plt.figure(figsize=figsize)
    plt.imshow(cm, interpolation="nearest")
    plt.title(title)
    plt.colorbar()
    ticks = np.arange(n)
    plt.xticks(ticks, class_names, rotation=45)
    plt.yticks(ticks, class_names)
    thresh = cm.max() / 2.0 if cm.max() else 0.5
    for i, j in np.ndindex(cm.shape):
        plt.text(
            j, i, format(cm[i, j], "d"), ha="center", va="center",
            color="white" if cm[i, j] > thresh else "black",
        )
    plt.tight_layout()
    plt.ylabel("True label")
    plt.xlabel("Predicted label")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"confusion_matrix_{title}.png")
    plt.savefig(path)
    plt.close()
    return path


def plot_line(
    x_values: Sequence[float],
    y_values: Sequence[float],
    title: str = "Line Plot",
    x_label: str = "X-axis",
    y_label: str = "Y-axis",
    out_dir: str = "./plots",
) -> str:
    """Accuracy-vs-hyperparameter plot (reference visualizer.py:47-67)."""
    if len(x_values) != len(y_values):
        raise ValueError("x_values and y_values must have the same length")
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure()
    plt.plot(x_values, y_values)
    plt.title(title)
    plt.xlabel(x_label)
    plt.ylabel(y_label)
    plt.grid(True)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{title.replace(' ', '_')}.png")
    plt.savefig(path)
    plt.close()
    return path
