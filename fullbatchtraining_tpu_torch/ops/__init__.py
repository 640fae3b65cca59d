"""Hand-written CUDA kernels of the port (built from ``csrc/`` at first use)."""

from . import bn, pool

__all__ = ["bn", "pool"]
