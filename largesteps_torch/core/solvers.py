"""Dense-inverse Cholesky solver and the differentiable solve.

Port of ``largesteps_tpu/core/solvers.py`` (the ``n <= DENSE_LIMIT`` tier
of ``CholeskySolver`` and the custom-VJP ``solve``).  Once per topology
epoch the dense ``M`` is factored with ``torch.linalg.cholesky`` and its
inverse formed with ``torch.cholesky_inverse``; each solve is then one
``inv @ b``.  Both run in full float32: TF32 is switched off around them
explicitly, whatever the process-wide setting.  The banded/AMG tiers above
``DENSE_LIMIT`` and the CG solver are later slices (ROADMAP.md Queue 1).
"""
from __future__ import annotations

import torch

from .sparse import SparseCOO

__all__ = ["CholeskySolver", "solve", "DENSE_LIMIT", "full_fp32"]

DENSE_LIMIT = 32768


class full_fp32:
    """Context that keeps float32 matrix products out of TF32 on the card,
    restoring the caller's setting on exit."""

    def __enter__(self):
        self._prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self._prev
        return False


class CholeskySolver:
    """Direct solver for SPD ``M``: explicit inverse, built once."""

    tier = "dense_inv"

    def __init__(self, M: SparseCOO, dense_limit: int = DENSE_LIMIT):
        self.n = M.shape[0]
        self.M = M
        if self.n > dense_limit:
            raise NotImplementedError(
                f"{self.n} vertices exceed the dense-inverse tier "
                f"({dense_limit}); the banded and block-AMG tiers are the "
                f"large-F slice (ROADMAP.md Queue 1, item 8)")
        with full_fp32():
            A = M.todense()
            L = torch.linalg.cholesky(A)
            self.inv = torch.cholesky_inverse(L)

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        with full_fp32():
            return self.inv @ b


class _Solve(torch.autograd.Function):
    """x = M⁻¹ b; the backward solves again with the same solver (M = Mᵀ).
    No gradient reaches the matrix."""

    @staticmethod
    def forward(ctx, b, solver):
        ctx.solver = solver
        return solver.solve(b)

    @staticmethod
    def backward(ctx, g):
        return ctx.solver.solve(g), None


def solve(solver, b: torch.Tensor):
    """Differentiable ``M⁻¹ b``."""
    return _Solve.apply(b, solver)
