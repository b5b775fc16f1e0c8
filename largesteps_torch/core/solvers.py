"""Sparse SPD solvers for ``M x = b`` and the differentiable solve.

Port of ``largesteps_tpu/core/solvers.py``:

* ``cg_solve`` and ``ConjugateGradientSolver``: CG batched over the k
  columns of ``b``, each column with its own α and β, a column frozen once
  its absolute residual norm is at most ``tol`` (at most ``max_iter``
  iterations).  The loop runs from Python; it tests whether any column is
  still active every ``CHECK_EVERY`` iterations, which is one host sync
  each time: frozen columns do not move, so the ``x`` is the one of a test
  every iteration.  The solver keeps the last solve's iteration count.
* ``CholeskySolver``, tiered by size: up to ``dense_limit`` vertices the
  dense ``M`` is factored once per topology epoch with
  ``torch.linalg.cholesky`` and its inverse formed with
  ``torch.cholesky_inverse`` (each solve one ``inv @ b``, ``refine``
  passes of iterative refinement on request); above it the RCM-reordered
  system is factored block-tridiagonally (:mod:`.banded`), and where the
  RCM bandwidth needs a block past ``max_block`` it falls back to
  ``BlockAmgSolver``: RCM order, the dense-block matvec
  (:mod:`.blocksp`) on levels of ``BLOCK_LIMIT`` rows or more, and
  AMG-preconditioned CG (:mod:`.multigrid`) at tolerance 1e-6.
* ``CholeskyHostSolver`` factors ``M`` on the host in float64 with the
  simplicial LLᵀ of ``native/cholesky.cpp``; unlike the JAX class it has
  no SuperLU fallback: a failed build or factorization raises.
* ``solve(solver, b, guess_fwd, guess_bwd)``: ``M⁻¹ b`` with a backward
  that solves again with the same solver (M = Mᵀ).  The guesses warm-start
  the iterative solvers (the forward's and the backward's); direct ones
  ignore them.  No gradient reaches the matrix or the guesses.

Everything runs in full float32: TF32 is switched off around the products
explicitly, whatever the process-wide setting.  No solver keeps its
matrix's ``CooStructure`` (only :class:`.sparse.CooMatvec`), so the solver
cache can drop it when the structure goes.
"""
from __future__ import annotations

import numpy as np
import torch

from ..spans import setup_span, span
from .banded import BandedSolver, BandedUnsuitable
from .blocksp import permuted_coo, rcm_permutation
from .sparse import CooMatvec, SparseCOO

__all__ = ["CholeskySolver", "CholeskyHostSolver", "ConjugateGradientSolver",
           "BlockAmgSolver", "cg_solve", "solve", "DENSE_LIMIT", "full_fp32"]

DENSE_LIMIT = 32768
CHECK_EVERY = 4     # CG iterations between tests of the stopping rule


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


def col_norm(a: torch.Tensor) -> torch.Tensor:
    """The 2-norm of each column of (n, k) ``a``.  (``torch.linalg.
    vector_norm`` over dim 0 adds the squares one after another on the CPU,
    1e-6 off in float32 at 2,562 rows: enough to cost CG iterations near its
    tolerance.)"""
    return a.square().sum(0).sqrt()


def _cg(matvec, b, x0, tol, max_iter):
    """(x, iterations as a device scalar): the loop of :func:`cg_solve`."""
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
        x0 = None if x0 is None else x0[:, None]
    x = torch.zeros_like(b) if x0 is None else x0
    with torch.no_grad(), full_fp32():
        r = matvec(x) - b
        p = -r
        r_norm = col_norm(r)
        count = torch.zeros(b.shape[1], dtype=torch.int32, device=b.device)
        for it in range(max_iter):
            if it % CHECK_EVERY == 0 and not bool((r_norm > tol).any()):
                break
            active = r_norm > tol
            Ap = matvec(p)
            r2 = r_norm ** 2
            pAp = (p * Ap).sum(0)
            alpha = torch.where(active, r2 / torch.where(pAp == 0, 1.0, pAp),
                                0.0)
            x = x + alpha * p
            r_new = r + alpha * Ap
            r_new_norm = col_norm(r_new)
            beta = torch.where(active, r_new_norm ** 2 /
                               torch.where(r2 == 0, 1.0, r2), 0.0)
            p = torch.where(active, -r_new + beta * p, p)
            r = torch.where(active, r_new, r)
            r_norm = torch.where(active, r_new_norm, r_norm)
            count += active
    return (x[:, 0] if squeeze else x), count.max()


def cg_solve(M: SparseCOO, b: torch.Tensor, x0: torch.Tensor | None = None,
             tol: float = 1e-5, max_iter: int = 10000) -> torch.Tensor:
    """Batched CG for SPD ``M`` and b of shape (n,) or (n, k)."""
    return _cg(CooMatvec(M).matvec, b, x0, tol, max_iter)[0]


class ConjugateGradientSolver:
    """CG behind the solver surface; warm starts are passed to ``solve``.
    ``iters`` holds the last solve's iteration count (a device scalar)."""

    method = "CG"
    tier = "cg"

    def __init__(self, M: SparseCOO, tol: float = 1e-5):
        self._A = CooMatvec(M)
        self.tol = tol
        self.n = M.shape[0]
        self.iters = None

    def solve(self, b, x0=None):
        x, self.iters = _cg(self._A.matvec, b, x0, self.tol, 10000)
        return x


class CholeskySolver:
    """Direct solver for SPD ``M``, factored once, tiered by size: the
    explicit inverse up to ``dense_limit`` rows, the banded factor above,
    block-AMG where the banded tier refuses the bandwidth."""

    def __init__(self, M: SparseCOO, dense_limit: int = DENSE_LIMIT,
                 refine: int = 0, max_block: int = 2048):
        self.n = M.shape[0]
        self.refine = int(refine)
        self.inv = self._big = self._A = None
        if self.n <= dense_limit:
            with full_fp32(), setup_span("setup.factor"):
                A = M.todense()
                L = torch.linalg.cholesky(A)
                self.inv = torch.cholesky_inverse(L)
            if self.refine:
                self._A = CooMatvec(M)
            return
        try:
            # refine 0: the factor alone reaches about 2e-6 relative
            # residual, tighter than CG's 1e-5 stopping tolerance
            self._big = BandedSolver(M, refine=0, max_block=max_block)
        except BandedUnsuitable:
            self._big = BlockAmgSolver(M, tol=1e-6)

    @property
    def tier(self) -> str:
        """Which implementation runs: ``dense_inv``, ``banded`` or
        ``blockamg``."""
        if self.inv is not None:
            return "dense_inv"
        return "banded" if isinstance(self._big, BandedSolver) else "blockamg"

    @property
    def iters(self):
        """The last solve's iteration count on the block-AMG tier, else
        None."""
        return getattr(self._big, "iters", None)

    def solve(self, b: torch.Tensor, x0=None) -> torch.Tensor:
        """``M⁻¹ b``; ``x0`` warm-starts the block-AMG tier only."""
        if self._big is not None:
            return self._big.solve(b, x0)
        with full_fp32():
            x = self.inv @ b
            for _ in range(self.refine):
                x = x + self.inv @ (b - self._A.matvec(x))
        return x


class CholeskyHostSolver:
    """Direct solver for SPD ``M``, factored once on the host in float64
    (``native/cholesky.cpp``, reverse Cuthill-McKee order).  A solve copies
    ``b`` to the host, solves in float64 and returns ``x`` on ``b``'s device
    in ``b``'s dtype."""

    tier = "host"

    def __init__(self, M: SparseCOO):
        from ..native.cholesky import factorize
        st = M.structure
        self.n = st.shape[0]
        vals = M.vals.detach().cpu().numpy().astype(np.float64)
        with setup_span("setup.factor"):
            self._factor = factorize(self.n, st.rows, st.cols, vals)

    def solve(self, b: torch.Tensor, x0=None) -> torch.Tensor:
        x = self._factor.solve(b.detach().cpu().numpy())
        return torch.as_tensor(x).to(device=b.device, dtype=b.dtype)


class BlockAmgSolver:
    """The large-mesh iterative tier: RCM order, the dense-block matvec on
    the levels of ``BLOCK_LIMIT`` rows or more, AMG-preconditioned CG.
    Solves run in the permuted space, padded to whole blocks; ``b`` and
    ``x`` cross into it by one gather each way."""

    method = "BlockAMG"
    tier = "blockamg"
    BLOCK_LIMIT = 8192       # levels below this stay on the COO matvec

    def __init__(self, M: SparseCOO, tol: float = 1e-6, block: int = 128):
        from .multigrid import MultigridSolver

        st = M.structure
        n = st.shape[0]
        with setup_span("setup.rcm"):
            perm, inv = rcm_permutation(st.rows, st.cols, n)
        self.n = n
        self.n_pad = ((n + block - 1) // block) * block
        self.perm = torch.as_tensor(perm, device=M.device)
        self.inv_perm = torch.as_tensor(inv, device=M.device)
        self._mg = MultigridSolver(permuted_coo(M, inv, self.n_pad), tol=tol,
                                   block_limit=self.BLOCK_LIMIT)

    @property
    def iters(self):
        return self._mg.iters

    def _to_permuted(self, a):
        out = torch.zeros((self.n_pad, a.shape[1]), dtype=a.dtype,
                          device=a.device)
        out[:self.n] = a[self.perm]
        return out

    def solve(self, b, x0=None):
        squeeze = b.ndim == 1
        if squeeze:
            b = b[:, None]
            x0 = None if x0 is None else x0[:, None]
        xp = self._mg.solve(self._to_permuted(b),
                            None if x0 is None else self._to_permuted(x0))
        x = xp[self.inv_perm]
        return x[:, 0] if squeeze else x


class _Solve(torch.autograd.Function):
    """x = M⁻¹ b; the backward solves again with the same solver (M = Mᵀ),
    in the span ``adjoint_solve``.  No gradient reaches the matrix or the
    guesses."""

    @staticmethod
    def forward(ctx, b, solver, guess_fwd, guess_bwd):
        ctx.solver, ctx.guess_bwd = solver, guess_bwd
        return solver.solve(b, guess_fwd)

    @staticmethod
    def backward(ctx, g):
        with span("adjoint_solve"):
            return ctx.solver.solve(g, ctx.guess_bwd), None, None, None


def solve(solver, b: torch.Tensor, guess_fwd=None, guess_bwd=None):
    """Differentiable ``M⁻¹ b``; ``guess_fwd`` and ``guess_bwd`` warm-start
    the forward and the backward solve of an iterative solver."""
    return _Solve.apply(b, solver, guess_fwd, guess_bwd)
