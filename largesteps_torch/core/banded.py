"""Block-tridiagonal LDLᵀ: the factor-once direct solver for large meshes.

Port of ``largesteps_tpu/core/banded.py`` (``BandedSolver``,
``BandedUnsuitable``, lines 59-207).  After a reverse Cuthill-McKee
reordering, the mesh system ``M = I + λL`` has half-bandwidth β = O(√n).
With a block size B ≥ β the permuted matrix is block-tridiagonal: every
nonzero lies in a diagonal block Dᵢ or a sub-diagonal block Eᵢ of size
B × B.  Block LDLᵀ factors it once per topology epoch::

    factor:  Lᵢ = Eᵢ·inv(D'ᵢ₋₁);  D'ᵢ = Dᵢ − Lᵢ·Eᵢᵀ;  keep inv(D'ᵢ) and Lᵢ
    solve:   forward  yᵢ = bᵢ − Lᵢ·yᵢ₋₁
             backward xᵢ = inv(D'ᵢ)·yᵢ − Lᵢ₊₁ᵀ·xᵢ₊₁

The blocks are assembled on the device from the COO values with
``index_put_``; the factor and each solve are Python loops over the nb
blocks of (B, B) products, all in full float32 (TF32 off: the tier's
~2e-6 relative residual needs it).  At 163,842 vertices B = 768 and
nb = 214, and ``inv(D')`` and ``L`` take about 505 MB each.  With
``refine=k`` a solve adds k passes of iterative refinement, each solving
again for the residual ``b − M x`` (a COO matvec).
"""
from __future__ import annotations

import numpy as np
import torch

from ..spans import setup_span
from .blocksp import rcm_permutation
from .sparse import CooMatvec, SparseCOO

__all__ = ["BandedSolver", "BandedUnsuitable"]


class BandedUnsuitable(Exception):
    """The RCM bandwidth needs a block larger than ``max_block``."""


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class BandedSolver:
    """RCM + block-tridiagonal LDLᵀ solver for SPD mesh systems."""

    method = "Banded"

    def __init__(self, M: SparseCOO, refine: int = 0, max_block: int = 2048):
        from .solvers import full_fp32

        st = M.structure
        n = st.shape[0]
        with setup_span("setup.rcm"):
            perm, inv = rcm_permutation(st.rows, st.cols, n)
        r2 = inv[st.rows.astype(np.int64)]
        c2 = inv[st.cols.astype(np.int64)]
        bw = int(np.abs(r2 - c2).max()) if len(r2) else 0
        B = max(128, _round_up(bw + 1, 128))
        if B > max_block:
            raise BandedUnsuitable(
                f"RCM bandwidth {bw} needs block {B} > max_block {max_block}")
        nb = max(1, _round_up(n, B) // B)
        self.n, self.B, self.nb, self.refine = n, B, nb, int(refine)
        # the residual's matvec, for the refinement passes
        self._A = CooMatvec(M) if self.refine else None

        dev = M.vals.device
        idx = lambda a: torch.as_tensor(a, dtype=torch.int64, device=dev)
        vals = M.vals.to(torch.float32)
        bi, bj = r2 // B, c2 // B
        D = torch.zeros((nb, B, B), dtype=torch.float32, device=dev)
        E = torch.zeros_like(D)
        diag = bi == bj
        sub = bi == bj + 1          # strictly lower blocks (Eᵢ); the upper
        for blocks, m in ((D, diag), (E, sub)):   # ones are their transposes
            blocks.index_put_((idx(bi[m]), idx(r2[m] % B), idx(c2[m] % B)),
                              vals[idx(np.flatnonzero(m))], accumulate=True)
        # identity on the padded tail rows keeps the operator SPD
        pad = np.arange(n, nb * B)
        D.index_put_((idx(pad // B), idx(pad % B), idx(pad % B)),
                     torch.ones(len(pad), device=dev), accumulate=True)
        with full_fp32(), setup_span("setup.factor"):
            self.invDp, self.L = _factorize(D, E)
        self.perm = idx(perm)
        self.inv_perm = idx(inv)

    def _solve_once(self, b: torch.Tensor) -> torch.Tensor:
        from .solvers import full_fp32

        k = b.shape[1]
        bp = torch.zeros((self.nb * self.B, k), dtype=torch.float32,
                         device=b.device)
        bp[:self.n] = b[self.perm]
        with full_fp32():
            x = _solve_blocks(self.invDp, self.L, bp.view(self.nb, self.B, k))
        return x.view(-1, k)[:self.n][self.inv_perm]

    def solve(self, b: torch.Tensor, x0=None) -> torch.Tensor:
        """``M⁻¹ b`` for b of shape (n, k) or (n,); ``x0`` is ignored
        (direct)."""
        squeeze = b.ndim == 1
        if squeeze:
            b = b[:, None]
        x = self._solve_once(b)
        for _ in range(self.refine):
            x = x + self._solve_once(b - self._A.matvec(x))
        return x[:, 0] if squeeze else x


def _factorize(D, E):
    """Block LDLᵀ in place: returns (inv(D'), L) in the storage of (D, E).
    E₀ = 0 by construction, so L₀ = 0."""
    nb = D.shape[0]
    info = torch.zeros((), dtype=torch.int32, device=D.device)
    prev = torch.zeros_like(D[0])
    for i in range(nb):
        L_i = E[i] @ prev
        Dp = D[i] - L_i @ E[i].mT
        c, err = torch.linalg.cholesky_ex(Dp)
        info = torch.maximum(info, err)        # read once, after the loop
        E[i] = L_i
        D[i] = torch.cholesky_inverse(c)
        prev = D[i]
    if int(info):
        raise torch.linalg.LinAlgError(
            "banded factor: a diagonal block is not positive definite")
    return D, E


def _solve_blocks(invDp, L, bb):
    """Two-sweep block-tridiagonal solve of stacked (nb, B, k) right-hand
    sides.  The backward sweep hands Lᵢ₊₁ᵀ xᵢ₊₁ down as its carry."""
    nb, B, k = bb.shape
    y = torch.empty_like(bb)
    prev = torch.zeros((B, k), dtype=bb.dtype, device=bb.device)
    for i in range(nb):
        prev = torch.addmm(bb[i], L[i], prev, alpha=-1.0, out=y[i])
    x = torch.empty_like(bb)
    carry = torch.zeros_like(prev)
    for i in range(nb - 1, -1, -1):
        torch.addmm(carry, invDp[i], y[i], beta=-1.0, out=x[i])
        carry = L[i].mT @ x[i]
    return x
