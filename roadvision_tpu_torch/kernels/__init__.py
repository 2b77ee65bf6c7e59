"""Build, loading and launch counts of the hand-written CUDA kernels."""
from ._build import build_all, launch_counts, reset_launch_counts

__all__ = ["build_all", "launch_counts", "reset_launch_counts"]
