"""Plots of loss surfaces (``fullbatchtraining_tpu/visualization/plotting.py``):
rows of training loss and accuracy along the x direction, one column a
store, and the contour of a 2D surface. matplotlib is imported inside the
calls, never when this module is."""

from __future__ import annotations

import os

import numpy as np

from .database import load_surface


def _pyplot():
    """matplotlib's pyplot, on the Agg backend where there is no display,
    with the plots' font and line settings."""
    import matplotlib

    if not os.environ.get("DISPLAY"):
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.rcParams["font.family"] = "serif"
    plt.rcParams["font.size"] = 14
    plt.rcParams["lines.linewidth"] = 4
    return plt


def plot_2d_contour(db_path, xcoords, ycoords, key="train_loss", levels=30, log_scale=True):
    """Filled contour of ``key`` over a 2D surface (``viz=2d``); returns
    ``(figure, landscape)``."""
    plt = _pyplot()
    positions = [(float(x), float(y)) for x in xcoords for y in ycoords]
    landscape = load_surface(db_path, positions)
    z = landscape[key].reshape(len(xcoords), len(ycoords)).T
    fig, ax = plt.subplots(figsize=(6, 5))
    values = np.log10(np.maximum(z, 1e-6)) if log_scale else z
    contour = ax.contourf(xcoords, ycoords, values, levels=levels, cmap="viridis")
    fig.colorbar(contour, ax=ax, label=f"log10 {key}" if log_scale else key)
    ax.set_xlabel("x direction")
    ax.set_ylabel("y direction")
    fig.tight_layout()
    return fig, landscape


def plot_1d_loss_err_row(base_data_dir, db_names, display_names, xcoords, positions,
                         figsize=None, xmin=-1.0, xmax=1.0, loss_max=5, log=False):
    """One column a store of ``db_names`` under ``base_data_dir``: loss (left
    axis) and accuracy in % (right axis) along x; returns ``(figure, the
    last store's landscape)``."""
    plt = _pyplot()
    ncols = len(db_names)
    fig, axes = plt.subplots(1, ncols, figsize=figsize or (5 * ncols, 5))
    axes = [axes] if ncols == 1 else list(axes)
    landscape = None
    for i, (ax1, db_name) in enumerate(zip(axes, db_names)):
        landscape = load_surface(os.path.join(base_data_dir, db_name), positions)
        ax2 = ax1.twinx()
        plot = ax1.semilogy if log else ax1.plot
        plot(xcoords, landscape["train_loss"], "b-", label="Training loss", linewidth=1)
        ax2.plot(xcoords, landscape["train_acc"] * 100, "r-", label="Training accuracy",
                 linewidth=1)
        ax1.set_xlim(xmin, xmax)
        if i == 0:
            ax1.set_ylabel("Loss", color="b", fontsize="xx-large")
        ax1.tick_params("y", colors="b", labelsize="x-large")
        ax1.tick_params("x", labelsize="x-large")
        ax1.set_ylim(0, loss_max)
        if i == ncols - 1:
            ax2.set_ylabel("Accuracy", color="r", fontsize="xx-large")
        ax2.tick_params("y", colors="r", labelsize="x-large")
        ax2.set_ylim(0, 100)
        ax1.set_title(display_names[i], fontsize="x-large", y=1.03)
    fig.tight_layout()
    return fig, landscape
