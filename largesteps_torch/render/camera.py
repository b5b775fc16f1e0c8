"""Cameras: perspective projection and model-view-projection stacks.

Port of ``largesteps_tpu/render/camera.py`` (reference scripts/render.py:
89-111, including the negated-x first row of the Mitsuba convention).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["persp_proj", "build_mvps", "rotation_matrix",
           "translation_matrix", "project"]


def persp_proj(fov_x: float = 45.0, ar: float = 1.0, near: float = 0.1,
               far: float = 100.0) -> np.ndarray:
    """OpenGL-style projection from horizontal FoV (degrees) and aspect w/h:
    x negated, y scaled by aspect, depth mapped with [near, far], w' = +z."""
    fov_rad = np.deg2rad(fov_x)
    return np.array(
        [
            [-1.0 / np.tan(fov_rad / 2.0), 0, 0, 0],
            [0, ar / np.tan(fov_rad / 2.0), 0, 0],
            [0, 0, -(near + far) / (near - far), 2 * far * near / (near - far)],
            [0, 0, 1, 0],
        ],
        dtype=np.float32,
    )


def build_mvps(proj: np.ndarray, view_mats: np.ndarray) -> np.ndarray:
    """(C, 4, 4) MVP stack = proj @ view per camera."""
    return np.einsum("ij,cjk->cik", np.asarray(proj),
                     np.asarray(view_mats)).astype(np.float32)


def rotation_matrix(axis: str, angle_deg: float) -> np.ndarray:
    """Homogeneous rotation about x|y|z."""
    if axis not in ("x", "y", "z"):
        raise ValueError(f"invalid axis {axis!r}, expected x, y or z")
    mat = np.eye(4, dtype=np.float64)
    theta = np.deg2rad(angle_deg)
    idx = "xyz".find(axis)
    i1, i2 = (idx + 1) % 3, (idx + 2) % 3
    mat[i1, i1] = np.cos(theta)
    mat[i2, i2] = np.cos(theta)
    mat[i1, i2] = -np.sin(theta)
    mat[i2, i1] = np.sin(theta)
    return mat


def translation_matrix(tr) -> np.ndarray:
    """Homogeneous translation."""
    mat = np.eye(4, dtype=np.float64)
    mat[:3, 3] = np.asarray(tr, dtype=np.float64)
    return mat


def project(verts: torch.Tensor, mvps: torch.Tensor) -> torch.Tensor:
    """Clip-space transform of all cameras: (V, 3) × (C, 4, 4) → (C, V, 4).

    Written as four elementwise products summed in a fixed order rather
    than a matrix product, so the CPU and the card round alike and the
    rasterizer's coverage decisions agree between them bit for bit.
    """
    m = mvps[:, None, :, :]                                # (C, 1, 4, 4)
    x, y, z = (verts[None, :, None, k] for k in range(3))  # (1, V, 1)
    return ((m[..., 0] * x + m[..., 1] * y) + m[..., 2] * z) + m[..., 3]
