"""The loss surface: its crunch, its store and its plots."""

from .crunch import crunch
from .database import SurfaceStore, load_surface, surface_path
from .plotting import plot_1d_loss_err_row

__all__ = ["crunch", "SurfaceStore", "load_surface", "surface_path", "plot_1d_loss_err_row"]
