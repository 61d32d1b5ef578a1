"""Prediction visualization (the port's copy of `pointseg/utils/visualize.py`).

Rebuild of `visualize_predictions` (reference models/dgcnn/utils.py:261-329):
a 3-panel 3D scatter (predictions / ground truth / errors) saved to file.
matplotlib is optional — import is gated and a clear error raised if absent.
Also provides `plot_confusion_matrix` (reference Training/training.py:13-26)
without the seaborn dependency.
"""

from __future__ import annotations

import numpy as np


def _mpl():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt  # noqa: PLC0415

        return plt
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "matplotlib is required for visualization; install it or skip plots"
        ) from e


def visualize_predictions(
    points: np.ndarray,
    predictions: np.ndarray,
    labels: np.ndarray | None = None,
    save_path: str = "predictions.png",
    max_points: int = 20000,
    seed: int = 0,
) -> str:
    """3-panel predictions / ground-truth / errors scatter."""
    plt = _mpl()
    n = points.shape[0]
    if n > max_points:
        idx = np.random.default_rng(seed).permutation(n)[:max_points]
        points, predictions = points[idx], predictions[idx]
        labels = labels[idx] if labels is not None else None

    ncols = 3 if labels is not None else 1
    fig = plt.figure(figsize=(6 * ncols, 6))

    ax = fig.add_subplot(1, ncols, 1, projection="3d")
    ax.scatter(points[:, 0], points[:, 1], points[:, 2], c=predictions, s=1, cmap="tab20")
    ax.set_title("Predictions")

    if labels is not None:
        ax = fig.add_subplot(1, ncols, 2, projection="3d")
        ax.scatter(points[:, 0], points[:, 1], points[:, 2], c=labels, s=1, cmap="tab20")
        ax.set_title("Ground truth")

        ax = fig.add_subplot(1, ncols, 3, projection="3d")
        err = (predictions != labels).astype(np.float32)
        ax.scatter(points[:, 0], points[:, 1], points[:, 2], c=err, s=1, cmap="coolwarm")
        ax.set_title(f"Errors ({100.0 * err.mean():.1f}%)")

    fig.tight_layout()
    fig.savefig(save_path, dpi=120)
    plt.close(fig)
    return save_path


def plot_confusion_matrix(matrix: np.ndarray, save_path: str = "confusion.png") -> str:
    """Confusion-matrix heatmap (reference training.py:13-26, sans seaborn)."""
    plt = _mpl()
    c = matrix.shape[0]
    fig, ax = plt.subplots(figsize=(10, 8))
    im = ax.imshow(matrix, cmap="Blues")
    for i in range(c):
        for j in range(c):
            v = int(matrix[i, j])
            if v:
                ax.text(j, i, str(v), ha="center", va="center", fontsize=7)
    ax.set_xlabel("Predicted")
    ax.set_ylabel("True")
    ax.set_xticks(range(c), [str(i + 1) for i in range(c)])
    ax.set_yticks(range(c), [str(i + 1) for i in range(c)])
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    fig.savefig(save_path, dpi=120)
    plt.close(fig)
    return save_path
