"""The tiered Cholesky solver and the differentiable solve.

Port of ``largesteps_tpu/core/solvers.py`` (``CholeskySolver``, lines
133-215, and the custom-VJP ``solve``).  Up to ``dense_limit`` vertices the
dense ``M`` is factored once per topology epoch with
``torch.linalg.cholesky`` and its inverse formed with
``torch.cholesky_inverse``; each solve is then one ``inv @ b``.  Above it
the RCM-reordered system is factored block-tridiagonally
(:mod:`largesteps_torch.core.banded`).  Both run in full float32: TF32 is
switched off around them explicitly, whatever the process-wide setting.
The block-AMG tier (for bandwidths past ``max_block``) and the CG solver
are still to port (ROADMAP.md Queue 1).
"""
from __future__ import annotations

import torch

from .banded import BandedSolver, BandedUnsuitable
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
    """Direct solver for SPD ``M``, factored once, tiered by size: the
    explicit inverse up to ``dense_limit`` rows, the banded factor above."""

    def __init__(self, M: SparseCOO, dense_limit: int = DENSE_LIMIT,
                 max_block: int = 2048):
        self.n = M.shape[0]
        self.M = M
        self.inv = self._big = None
        if self.n <= dense_limit:
            with full_fp32():
                A = M.todense()
                L = torch.linalg.cholesky(A)
                self.inv = torch.cholesky_inverse(L)
            return
        try:
            self._big = BandedSolver(M, max_block=max_block)
        except BandedUnsuitable as e:
            raise NotImplementedError(
                f"{e}: such meshes need the block-AMG tier, still to port "
                f"(ROADMAP.md Queue 1, item 3)") from e

    @property
    def tier(self) -> str:
        """Which implementation runs: ``dense_inv`` or ``banded``."""
        return "dense_inv" if self.inv is not None else "banded"

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        if self._big is not None:
            return self._big.solve(b)
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
