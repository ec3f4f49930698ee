"""Plots of the drivers' ``--plot`` (port of the JAX ``evaluation/plots.py``;
the reference's plot code: TOYcINN.py:321-1206 scatter grids,
class-interpolation sweeps, loss curves; create_tfrecords.py:366-400 image
panels).

Every function takes numpy arrays (or lists of them) and saves a PNG under
matplotlib's ``Agg`` backend. matplotlib is imported inside the functions
only, so importing this module needs none; the drivers check for it when
their arguments are parsed (``drivers/common.py::check_plot``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_toy_joint(xy, path, title="data"):
    """Scatter of the 2-D point cloud colored by condition
    (TOYcINN.py:340-440 style)."""
    plt = _mpl()
    xy = np.asarray(xy).reshape(-1, xy.shape[-1])
    fig, ax = plt.subplots(figsize=(5, 5))
    sc = ax.scatter(xy[:, 0], xy[:, 1], c=xy[:, 2], s=2, cmap="viridis", alpha=0.6)
    fig.colorbar(sc, ax=ax, label="y")
    ax.set_title(title)
    ax.set_aspect("equal")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_toy_conditional_grid(samples_by_condition, conditions, path):
    """One panel per condition value: the conditional manifold x | y'
    (TOYcINN.py:438-757; includes off-manifold sweeps, TOYcINN.py:1115-1206)."""
    plt = _mpl()
    n = len(conditions)
    cols = min(n, 5)
    rows = -(-n // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 3 * rows), squeeze=False)
    for i, (s, c) in enumerate(zip(samples_by_condition, conditions)):
        ax = axes[i // cols][i % cols]
        s = np.asarray(s)
        ax.scatter(s[:, 0], s[:, 1], s=2, alpha=0.5)
        ax.set_title(f"y' = {float(c):.2f}")
        ax.set_aspect("equal")
    for j in range(n, rows * cols):
        axes[j // cols][j % cols].axis("off")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_latent(z, path):
    """Forward-mapped latent scatter — should look like N(0, I)."""
    plt = _mpl()
    z = np.asarray(z).reshape(-1, z.shape[-1])
    fig, ax = plt.subplots(figsize=(5, 5))
    ax.scatter(z[:, 0], z[:, 1], s=2, alpha=0.5)
    circle = plt.Circle((0, 0), 2.0, fill=False, color="r", ls="--")
    ax.add_patch(circle)
    ax.set_title("latent z (2-sigma circle)")
    ax.set_aspect("equal")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_loss_curves(history_rows, path, keys=("loss", "z_loss", "y_loss", "detJ_loss")):
    """Training-loss curves (TOYcINN.py:388-393)."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(7, 4))
    epochs = [r["epoch"] for r in history_rows]
    for k in keys:
        if history_rows and k in history_rows[0]:
            ax.plot(epochs, [r[k] for r in history_rows], label=k)
    ax.legend()
    ax.set_xlabel("epoch")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_y_identity(y_requested_enc, y_mapped_enc, y_requested_dec,
                    y_mapped_dec, path):
    """The y'-identity overlays (TOYcINN.py:463-492): f_Y(x, y') vs y' in the
    encode direction and the recovered y vs the requested y' in the decode
    direction. Both should sit on the identity line (discrete conditions
    collapse to points ON that line)."""
    plt = _mpl()
    fig, axes = plt.subplots(1, 2, figsize=(9, 4.2))
    panels = [
        (y_requested_enc, y_mapped_enc, "encode: f_Y(x, y') vs y'"),
        (y_requested_dec, y_mapped_dec, "decode: y recovered vs y' requested"),
    ]
    for ax, (req, mapped, title) in zip(axes, panels):
        req = np.asarray(req).reshape(-1)
        mapped = np.asarray(mapped).reshape(-1)
        lo = float(min(req.min(), mapped.min()))
        hi = float(max(req.max(), mapped.max()))
        pad = 0.1 * max(hi - lo, 1e-6)
        ax.plot([lo - pad, hi + pad], [lo - pad, hi + pad], "r--", lw=1,
                label="identity")
        ax.scatter(req, mapped, s=3, alpha=0.4)
        ax.set_xlabel("y' requested")
        ax.set_ylabel("y mapped")
        ax.set_title(title, fontsize=9)
        ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_forward_backward_grid(data_xy, encoded_zy, sampled_xy, path,
                               title="forward / backward maps"):
    """The reference's 2x2 forward/backward panel (TOYcINN.py:1098+ family):
    data joint -> encoded latent (top row), prior draw -> decoded samples
    (bottom row)."""
    plt = _mpl()
    data_xy = np.asarray(data_xy).reshape(-1, data_xy.shape[-1])
    encoded_zy = np.asarray(encoded_zy).reshape(-1, encoded_zy.shape[-1])
    sampled_xy = np.asarray(sampled_xy).reshape(-1, sampled_xy.shape[-1])
    fig, axes = plt.subplots(2, 2, figsize=(8.5, 8))
    ax = axes[0][0]
    sc = ax.scatter(data_xy[:, 0], data_xy[:, 1], c=data_xy[:, 2], s=2,
                    cmap="viridis", alpha=0.6)
    ax.set_title("data (x | colored by y')", fontsize=9)
    ax = axes[0][1]
    ax.scatter(encoded_zy[:, 0], encoded_zy[:, 1], c=data_xy[:, 2], s=2,
               cmap="viridis", alpha=0.6)
    ax.add_patch(plt.Circle((0, 0), 2.0, fill=False, color="r", ls="--"))
    ax.set_title("encoded z = f_Z(x, y') (2-sigma circle)", fontsize=9)
    ax = axes[1][0]
    rng = np.random.default_rng(0)
    z = rng.normal(size=(len(sampled_xy), 2))
    ax.scatter(z[:, 0], z[:, 1], s=2, alpha=0.4)
    ax.add_patch(plt.Circle((0, 0), 2.0, fill=False, color="r", ls="--"))
    ax.set_title("prior draw z ~ N(0, I)", fontsize=9)
    ax = axes[1][1]
    sc = ax.scatter(sampled_xy[:, 0], sampled_xy[:, 1], c=sampled_xy[:, 2],
                    s=2, cmap="viridis", alpha=0.6)
    ax.set_title("decoded x | y' (colored by y')", fontsize=9)
    for a in axes.ravel():
        a.set_aspect("equal")
    fig.colorbar(sc, ax=axes.ravel().tolist(), label="y'", shrink=0.8)
    fig.suptitle(title)
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_annealing_history(history_rows, path,
                           keys=("loss", "z_loss", "y_loss", "detJ_loss")):
    """Separate annealing-phase vs clean-phase loss curves — the reference
    keeps the two histories apart (TOYcINN.py:274-304) because annealing-
    epoch losses are measured on noise-blended data and are not comparable
    to the clean fit."""
    plt = _mpl()
    ann = [r for r in history_rows if r.get("alpha", 1.0) < 1.0]
    clean = [r for r in history_rows if r.get("alpha", 1.0) >= 1.0]
    fig, axes = plt.subplots(1, 2, figsize=(10, 4), sharey=False)
    for ax, rows, title in (
        (axes[0], ann, "annealing phase (alpha < 1)"),
        (axes[1], clean, "clean phase"),
    ):
        for k in keys:
            if rows and k in rows[0]:
                ax.plot([r["epoch"] for r in rows], [r[k] for r in rows],
                        label=k)
        ax.set_title(title, fontsize=9)
        ax.set_xlabel("epoch")
        if rows:
            ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def default_interpolation_conditions(class_labels, mean, std,
                                     num_interps=5, num_extras=2):
    """The reference's default class-interpolation grid (TOYcINN.py:1115-1126):
    ``num_interps`` evenly spaced values spanning the class-label range,
    extended ``num_extras`` steps beyond each end (off-manifold), then
    standardized with the dataset stats — for the canonical two-class case
    this is y' in {-2, -1.5, ..., 2}."""
    lo, hi = float(min(class_labels)), float(max(class_labels))
    step = (hi - lo) / (num_interps - 1)
    vals = [
        lo + (i - num_extras) * step
        for i in range(num_interps + 2 * num_extras)
    ]
    return [(v - mean) / std for v in vals]


def plot_image_grid(images, path, ncols=8, title=None):
    """Sample / verification image grid (create_tfrecords.py:366-400)."""
    plt = _mpl()
    images = np.asarray(images)
    n = len(images)
    ncols = min(ncols, n)
    nrows = -(-n // ncols)
    fig, axes = plt.subplots(nrows, ncols, figsize=(1.4 * ncols, 1.4 * nrows), squeeze=False)
    for i in range(nrows * ncols):
        ax = axes[i // ncols][i % ncols]
        ax.axis("off")
        if i < n:
            ax.imshow(images[i, ..., 0], cmap="gray")
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_sr_comparison(lowres_y, samples, truth, path, n=6):
    """Side-by-side SR panel: condition (upsampled low-res), model sample(s),
    ground truth."""
    plt = _mpl()
    fig, axes = plt.subplots(3, n, figsize=(1.6 * n, 5), squeeze=False)
    for i in range(n):
        for row, (img, label) in enumerate(
            [(lowres_y, "y (low-res)"), (samples, "sample"), (truth, "truth")]
        ):
            ax = axes[row][i]
            ax.axis("off")
            ax.imshow(np.asarray(img)[i, ..., 0], cmap="gray")
            if i == 0:
                ax.set_title(label, loc="left", fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
