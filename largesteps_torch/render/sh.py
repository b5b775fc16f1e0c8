"""Order-2 spherical-harmonics irradiance environment lighting.

Port of ``largesteps_tpu/render/sh.py`` (reference scripts/render.py:5-87):
the 9-coefficient irradiance approximation of an equirectangular envmap as a
4×4 quadratic form per colour channel, ``l = hᵀ M h`` with ``h = [n, 1]``.
The angular conventions are the JAX package's: θ = linspace(0, π) over rows,
φ = linspace(3π, π) over columns, x = sinθ cosφ, z = −sinθ sinφ, y = cosθ.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["sh_matrices", "sh_eval"]


def sh_matrices(envmap) -> torch.Tensor:
    """(3, 4, 4) RGB quadratic-form matrices from an envmap (H, W, ≥3),
    computed once per scene on the CPU in float32."""
    envmap = torch.as_tensor(np.asarray(envmap, np.float32))
    h, w = envmap.shape[:2]
    theta = torch.linspace(0.0, np.pi, h)[:, None] * torch.ones((1, w))
    phi = torch.ones((h, 1)) * torch.linspace(3 * np.pi, np.pi, w)[None, :]

    sin_theta = torch.sin(theta)
    x = sin_theta * torch.cos(phi)
    z = -sin_theta * torch.sin(phi)
    y = torch.cos(theta)

    Y0 = 0.282095 * torch.ones_like(x)
    Y1 = {-1: 0.488603 * z, 0: 0.488603 * x, 1: 0.488603 * y}
    Y2 = {
        0: 0.315392 * (3 * z * z - 1),
        1: 1.092548 * x * z,
        2: 0.546274 * (x * x - y * y),
        -2: 1.092548 * x * y,
        -1: 1.092548 * y * z,
    }

    radiance = envmap[..., :3]
    dt_dp = 2.0 * np.pi ** 2 / (w * h)
    st = sin_theta[..., None]

    def integ(Y):
        return (radiance * Y[..., None] * st * dt_dp).sum(dim=(0, 1))

    L0 = {0: integ(Y0)}
    L1 = {p: integ(Y1[p]) for p in (-1, 0, 1)}
    L2 = {p: integ(Y2[p]) for p in (-2, -1, 0, 1, 2)}

    c1, c2, c3, c4, c5 = 0.429043, 0.511664, 0.743125, 0.886227, 0.247708
    M = torch.stack([
        torch.stack([c1 * L2[2], c1 * L2[-2], c1 * L2[1], c2 * L1[1]]),
        torch.stack([c1 * L2[-2], -c1 * L2[2], c1 * L2[-1], c2 * L1[-1]]),
        torch.stack([c1 * L2[1], c1 * L2[-1], c3 * L2[0], c2 * L1[0]]),
        torch.stack([c2 * L1[1], c2 * L1[-1], c2 * L1[0],
                     c4 * L0[0] - c5 * L2[0]]),
    ])                                             # (4, 4, 3)
    return torch.movedim(M, 2, 0).contiguous()     # (3, 4, 4)


def sh_eval(M: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Irradiance at normals ``n`` (..., 3) → (..., 3) RGB."""
    shape = n.shape
    h = torch.cat([n.reshape(-1, 3),
                   torch.ones((n.reshape(-1, 3).shape[0], 1), dtype=n.dtype,
                              device=n.device)], dim=1)
    Mh = torch.einsum("cij,vj->cvi", M, h)        # (3, V, 4)
    l = torch.einsum("vi,cvi->vc", h, Mh)         # (V, 3)
    return l.reshape(*shape[:-1], 3)
