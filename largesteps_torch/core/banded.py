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
``index_put_``; the factor is a Python loop over the nb blocks of (B, B)
products, in full float32 (TF32 off: the tier's ~2e-6 relative residual
needs it).  At 163,842 vertices B = 768 and nb = 214, and ``inv(D')`` and
``L`` take about 505 MB each.  With ``refine=k`` a solve adds k passes of
iterative refinement, each solving again for the residual ``b − M x`` (a
COO matvec).

A solve goes through :func:`banded_sweep`: on the card one launch of the
hand-written kernel ``csrc/banded_sweep.cu`` (both sweeps, the gather of
``b`` through the RCM order and the scatter of ``x`` back; each launch adds
one to ``LAUNCHES["banded_sweep"]``), on the CPU the plain loop
``_solve_blocks``.  The kernel computes the backward sweep as ``zᵢ =
inv(D'ᵢ)·yᵢ`` for every block first, then ``xᵢ = zᵢ − Lᵢ₊₁ᵀ·xᵢ₊₁``, each
dot in a fixed order that :func:`banded_sweep_plain` repeats operation for
operation.
"""
from __future__ import annotations

import numpy as np
import torch

from ..spans import setup_span
from .blocksp import rcm_permutation
from .sparse import CooMatvec, SparseCOO

__all__ = ["BandedSolver", "BandedUnsuitable", "banded_sweep",
           "banded_sweep_plain", "LAUNCHES"]

LAUNCHES = {"banded_sweep": 0}
MAX_K = 4          # right-hand columns the kernel takes


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

    def _solve_once(self, b: torch.Tensor) -> torch.Tensor:
        return banded_sweep(self.invDp, self.L,
                            b.to(torch.float32).contiguous(), self.perm)

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


def _check_sweep(invDp, L, b, perm):
    """Raise unless the arguments are what the kernel takes: (nb, B, B)
    contiguous float32 factors with B a multiple of 128 up to 2048, b (n, k)
    contiguous float32 with n ≤ nb·B and k from 1 to ``MAX_K``, perm (n,)
    contiguous int64, all on one device, the factors on 16 bytes."""
    if L.ndim != 3 or L.shape[1] != L.shape[2] or invDp.shape != L.shape:
        raise ValueError(f"banded_sweep: factors of shapes "
                         f"{tuple(invDp.shape)} and {tuple(L.shape)}, want "
                         f"two (nb, B, B)")
    nb, B, _ = L.shape
    if B % 128 or not 128 <= B <= 2048 or nb < 1:
        raise ValueError(f"banded_sweep: block {B} is not a multiple of 128 "
                         f"in 128..2048 (nb {nb})")
    if b.ndim != 2 or not 1 <= b.shape[1] <= MAX_K:
        raise ValueError(f"banded_sweep: b of shape {tuple(b.shape)}, want "
                         f"(n, k) with k in 1..{MAX_K}")
    n = b.shape[0]
    if not 1 <= n <= nb * B or perm.shape != (n,):
        raise ValueError(f"banded_sweep: {n} rows and perm of shape "
                         f"{tuple(perm.shape)} for {nb} blocks of {B}")
    for name, t, dtype in (("invDp", invDp, torch.float32),
                           ("L", L, torch.float32), ("b", b, torch.float32),
                           ("perm", perm, torch.int64)):
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"banded_sweep: {name} must be a contiguous "
                             f"{dtype} tensor, got {t.dtype}"
                             f"{'' if t.is_contiguous() else ' (strided)'}")
        if t.device != b.device:
            raise ValueError(f"banded_sweep: {name} on {t.device}, b on "
                             f"{b.device}")
    if invDp.data_ptr() % 16 or L.data_ptr() % 16:
        raise ValueError("banded_sweep: factors must be 16-byte aligned")


def banded_sweep(invDp, L, b, perm):
    """``x`` (n, k) with ``x[perm[p]] = (M'⁻¹ b')[p]``, where ``b'[p] =
    b[perm[p]]`` zero-padded to nb·B rows and ``M'`` is the permuted system
    whose block factor is (``invDp``, ``L``).  A CUDA tensor goes to the
    kernel (one launch, counted in ``LAUNCHES``), which raises if it cannot
    build or launch; a CPU tensor to the plain loop ``_solve_blocks``."""
    _check_sweep(invDp, L, b, perm)
    nb, B, _ = L.shape
    n, k = b.shape
    if not b.is_cuda:
        from .solvers import full_fp32
        bp = torch.zeros((nb * B, k), dtype=torch.float32, device=b.device)
        bp[:n] = b[perm]
        with full_fp32():
            x = _solve_blocks(invDp, L, bp.view(nb, B, k)).view(-1, k)[:n]
        out = torch.empty_like(x)
        out[perm] = x
        return out
    from .. import _cuda
    out = torch.empty((n, k), dtype=torch.float32, device=b.device)
    # y, then z and x: a float and its tag a word (the launcher zeroes it)
    scratch = torch.empty(2 * nb * B * k, dtype=torch.int64, device=b.device)
    err = _cuda.library("banded_sweep")(
        invDp.data_ptr(), L.data_ptr(), b.data_ptr(), perm.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), n, B, nb, k,
        _cuda.stream(b.device))
    _cuda.check("banded_sweep", err)
    LAUNCHES["banded_sweep"] += 1
    return out


def _lane_dot(A, v):
    """``A @ v`` for A (..., R, B) and v (..., B, k) in the kernel's order:
    lane l of a warp adds the terms 32·t + l over each quarter of t, a
    butterfly adds the 32 lanes, and the quarters are added in order."""
    B = A.shape[-1]
    T = B // 32
    a = A.unflatten(-1, (T, 32)).unsqueeze(-1)          # (..., R, T, 32, 1)
    w = v.unflatten(-2, (T, 32)).unsqueeze(-4)          # (..., 1, T, 32, k)
    parts = []
    for h in range(4):
        s = torch.zeros(torch.broadcast_shapes(a[..., 0, :, :].shape,
                                               w[..., 0, :, :].shape),
                        dtype=A.dtype, device=A.device)
        for t in range(h * T // 4, (h + 1) * T // 4):
            s = s + a[..., t, :, :] * w[..., t, :, :]
        for width in (16, 8, 4, 2, 1):
            s = s[..., :width, :] + s[..., width:2 * width, :]
        parts.append(s[..., 0, :])
    return ((parts[0] + parts[1]) + parts[2]) + parts[3]


def banded_sweep_plain(invDp, L, bb):
    """The kernel's arithmetic on stacked (nb, B, k) right-hand sides in
    the permuted order, operation for operation: the forward sweep, every
    ``zᵢ = inv(D'ᵢ)·yᵢ``, then ``xᵢ = zᵢ − Lᵢ₊₁ᵀ·xᵢ₊₁``.  ``L₀`` is not
    read (the factor's is 0).  The tests and ``chip_smoke.py`` hold the
    kernel to it."""
    nb = bb.shape[0]
    y = bb.clone()
    for i in range(1, nb):
        y[i] = bb[i] - _lane_dot(L[i], y[i - 1])
    x = _lane_dot(invDp, y)
    for i in range(nb - 2, -1, -1):
        x[i] = x[i] - _lane_dot(L[i + 1].mT, x[i + 1])
    return x
