"""The optimization driver."""
from .optimize_shape import optimize_shape, default_params

__all__ = ["optimize_shape", "default_params"]
