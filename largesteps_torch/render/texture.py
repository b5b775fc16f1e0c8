"""Bilinear texture sampling (nvdiffrast 'linear' filter semantics).

Port of ``largesteps_tpu/render/texture.py``: UV in [0, 1] maps to texel
centres at (u·W − 0.5, v·H − 0.5), clamped at the edges.
"""
from __future__ import annotations

import torch

__all__ = ["texture_bilinear"]


def texture_bilinear(tex: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Sample ``tex`` (H, W, C) at ``uv`` (..., 2)."""
    H, W = tex.shape[0], tex.shape[1]
    x = uv[..., 0] * W - 0.5
    y = uv[..., 1] * H - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]

    def at(xi, yi):
        xi = torch.clamp(xi.to(torch.int64), 0, W - 1)
        yi = torch.clamp(yi.to(torch.int64), 0, H - 1)
        return tex[yi, xi]

    t00 = at(x0, y0)
    t10 = at(x0 + 1, y0)
    t01 = at(x0, y0 + 1)
    t11 = at(x0 + 1, y0 + 1)
    return (t00 * (1 - fx) * (1 - fy) + t10 * fx * (1 - fy)
            + t01 * (1 - fx) * fy + t11 * fx * fy)
