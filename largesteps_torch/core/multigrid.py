"""Algebraic-multigrid-preconditioned CG for large mesh systems.

Port of ``largesteps_tpu/core/multigrid.py``.  An aggregation AMG
hierarchy is built once per topology epoch on the host and applied on the
device as a V(1,1)-cycle inside CG:

* host setup: greedy graph aggregation (``greedy_aggregate``, numpy,
  copied: deterministic, seed 0), the Galerkin coarse operator ``Pᵀ A P``
  of the piecewise-constant prolongation in float64 (relabel and coalesce
  the COO coordinates), recursing until the coarsest level has at most
  ``coarse_limit`` rows; that level's dense inverse by
  ``torch.linalg.cholesky`` and ``torch.cholesky_inverse`` on the device;
* device apply: weighted-Jacobi smoothing (ω = 0.8), restriction as a
  segment sum over the aggregates in a fixed order (``ops/segment.py``;
  ``index_add`` on the card adds in no fixed order), prolongation as a
  gather, the coarsest level one product with the dense inverse in full
  float32.

Levels of ``block_limit`` rows or more run the dense-block matvec
(``core/blocksp.py:BlockedOperator``), the others a COO matvec
(``core/sparse.py:CooMatvec``); no level keeps a ``CooStructure``, so the
solver cache can drop the solver with its matrix's structure.

``amg_pcg_solve`` keeps ``core/solvers.py:cg_solve``'s contract: per
column α and β, a column frozen once its absolute residual norm is at most
``tol``, at most ``max_iter`` iterations.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .blocksp import BlockedOperator
from .solvers import CHECK_EVERY, col_norm, full_fp32
from ..ops.segment import Segments
from .sparse import CooMatvec, CooStructure, SparseCOO

__all__ = ["AmgHierarchy", "build_hierarchy", "vcycle", "amg_pcg_solve",
           "MultigridSolver", "greedy_aggregate", "describe"]


def greedy_aggregate(rows: np.ndarray, cols: np.ndarray, n: int) -> np.ndarray:
    """Greedy aggregation of the matrix graph (host, vectorized).

    Each round picks the unclaimed vertices that are local minima of a
    fixed random priority among their unclaimed neighbours (an independent
    set, so their star aggregates never collide), and each root claims its
    unclaimed neighbours.  Leftovers join the adjacent aggregate they share
    the most edges with; isolated vertices become singletons.  Returns
    agg_id (n,) int32 with ids in [0, n_aggregates).
    """
    off = rows != cols
    r = rows[off].astype(np.int64)
    c = cols[off].astype(np.int64)
    rng = np.random.default_rng(0)               # deterministic
    pri = rng.permutation(n).astype(np.int64)
    vert_of_pri = np.empty(n, np.int64)
    vert_of_pri[pri] = np.arange(n)
    agg = np.full(n, -1, np.int64)
    n_agg = 0

    for _round in range(8):
        unclaimed = agg < 0
        if not unclaimed.any():
            break
        m = unclaimed[r] & unclaimed[c]
        rr, cc = r[m], c[m]
        # local priority minima among unclaimed neighbours -> roots
        nb_min = np.full(n, n, np.int64)
        np.minimum.at(nb_min, rr, pri[cc])
        is_root = unclaimed & (pri < nb_min)
        roots = np.flatnonzero(is_root)
        if roots.size == 0:
            break
        agg[roots] = n_agg + np.arange(roots.size)
        n_agg += roots.size
        # claim: each unclaimed non-root joins its min-priority adjacent root
        best = np.full(n, n, np.int64)
        sel = unclaimed[rr] & ~is_root[rr] & is_root[cc]
        np.minimum.at(best, rr[sel], pri[cc[sel]])
        claimed = best < n
        agg[claimed] = agg[vert_of_pri[best[claimed]]]

    # attach leftovers to the most-connected neighbouring aggregate,
    # iterating so that chains of leftovers resolve
    for _ in range(8):
        left = agg < 0
        if not left.any():
            break
        m = left[r] & (agg[c] >= 0)
        if not m.any():
            break
        rr, cc = r[m], c[m]
        pair = rr * (n_agg + 1) + agg[cc]
        uniq, cnt = np.unique(pair, return_counts=True)
        v_of = uniq // (n_agg + 1)
        a_of = uniq % (n_agg + 1)
        order = np.lexsort((cnt, v_of))          # per vertex, ascending count
        last = np.flatnonzero(
            np.r_[v_of[order][1:] != v_of[order][:-1], True])
        pick = order[last]
        agg[v_of[pick]] = a_of[pick]
    isolated = np.flatnonzero(agg < 0)
    if isolated.size:
        agg[isolated] = n_agg + np.arange(isolated.size)
        n_agg += isolated.size
    return agg.astype(np.int32)


@dataclasses.dataclass
class _Level:
    op: object                        # CooMatvec | BlockedOperator
    inv_diag: torch.Tensor            # 1 / diag(A)
    agg: torch.Tensor | None          # fine row -> coarse aggregate id
    n_coarse: int | None
    agg_segments: Segments | None = None   # the fine rows of each aggregate


@dataclasses.dataclass
class AmgHierarchy:
    levels: list                      # of _Level, fine -> coarse
    coarse_inv: torch.Tensor          # dense inverse at the coarsest level
    omega: float = 0.8


def build_hierarchy(M: SparseCOO, coarse_limit: int = 4096,
                    max_levels: int = 6, omega: float = 0.8,
                    block_limit: int | None = None,
                    block: int = 128) -> AmgHierarchy:
    """The AMG hierarchy of SPD ``M`` (host setup, tensors on ``M``'s
    device).  Levels of at least ``block_limit`` rows take the dense-block
    matvec; ``M`` must then already be bandwidth-ordered for it to pay."""

    def make_op(A):
        if block_limit is not None and A.shape[0] >= block_limit:
            return BlockedOperator(A, np.arange(A.shape[0], dtype=np.int64),
                                   block)
        return CooMatvec(A)

    dev = M.device
    levels = []
    rows = M.structure.rows.astype(np.int64)
    cols = M.structure.cols.astype(np.int64)
    vals = M.vals.detach().cpu().numpy().astype(np.float64)
    n = M.shape[0]
    A = M

    while n > coarse_limit and len(levels) < max_levels:
        agg = greedy_aggregate(rows.astype(np.int32), cols.astype(np.int32), n)
        n_c = int(agg.max()) + 1
        if n_c >= n:       # aggregation stalled
            break
        levels.append(_Level(
            op=make_op(A), inv_diag=1.0 / A.diagonal().detach(),
            agg=torch.as_tensor(agg.astype(np.int64), device=dev),
            n_coarse=n_c, agg_segments=Segments(agg, n_c, dev)))
        # Galerkin coarse operator: relabel and coalesce (numpy, float64)
        lin = agg[rows].astype(np.int64) * n_c + agg[cols]
        uniq, inv = np.unique(lin, return_inverse=True)
        v_c = np.zeros(len(uniq), np.float64)
        np.add.at(v_c, inv, vals)
        st = CooStructure((uniq // n_c).astype(np.int32),
                          (uniq % n_c).astype(np.int32), (n_c, n_c))
        # CooStructure sorts again; map the values into its slot order
        v_sorted = np.zeros(st.nnz, np.float64)
        np.add.at(v_sorted, st.slot, v_c)
        A = SparseCOO(st, torch.as_tensor(v_sorted.astype(np.float32),
                                          device=dev))
        rows = st.rows.astype(np.int64)
        cols = st.cols.astype(np.int64)
        vals = v_sorted
        n = n_c

    # the coarsest level: its dense inverse, in full float32
    dense = np.zeros((n, n), np.float64)
    dense[rows, cols] = vals
    with full_fp32():
        c = torch.linalg.cholesky(torch.as_tensor(dense.astype(np.float32),
                                                  device=dev))
        inv = torch.cholesky_inverse(c)
    levels.append(_Level(op=make_op(A), inv_diag=1.0 / A.diagonal().detach(),
                         agg=None, n_coarse=None))
    return AmgHierarchy(levels=levels, coarse_inv=inv, omega=omega)


def describe(h: AmgHierarchy) -> dict:
    """The hierarchy's rows a level, blocks of each blocked level (None for
    a COO one) and the bytes its blocks and the coarse inverse hold."""
    blocked = [lv.op for lv in h.levels if isinstance(lv.op, BlockedOperator)]
    return {"level_rows": [int(lv.inv_diag.shape[0]) for lv in h.levels],
            "level_blocks": [lv.op.n_blocks if isinstance(
                lv.op, BlockedOperator) else None for lv in h.levels],
            "block_bytes": sum(op.hbm_bytes for op in blocked),
            "coarse_inv_bytes": h.coarse_inv.numel() * 4}


def vcycle(h: AmgHierarchy, b: torch.Tensor, lvl: int = 0) -> torch.Tensor:
    """One V(1,1)-cycle approximating A⁻¹ b at level ``lvl``."""
    level = h.levels[lvl]
    if lvl == len(h.levels) - 1:
        with full_fp32():
            return h.coarse_inv @ b
    om = h.omega
    d = level.inv_diag[:, None] if b.ndim == 2 else level.inv_diag
    # pre-smooth from zero: x = ω D⁻¹ b
    x = om * d * b
    r = b - level.op.matvec(x)
    r_c = level.agg_segments.sum(r)
    x = x + vcycle(h, r_c, lvl + 1)[level.agg]
    # post-smooth
    return x + om * d * (b - level.op.matvec(x))


def _amg_pcg(h, b, x0, tol, max_iter):
    """(x, iterations as a device scalar): PCG with the V-cycle as
    preconditioner, the loop of :func:`amg_pcg_solve`."""
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
        x0 = None if x0 is None else x0[:, None]
    x = torch.zeros_like(b) if x0 is None else x0
    matvec = h.levels[0].op.matvec
    with torch.no_grad(), full_fp32():
        r = b - matvec(x)
        z = vcycle(h, r)
        p = z
        rz = (r * z).sum(0)
        r_norm = col_norm(r)
        count = torch.zeros(b.shape[1], dtype=torch.int32, device=b.device)
        for it in range(max_iter):
            # converged columns are frozen (α = β = 0), so testing the flag
            # every few iterations gives the x of testing it every one
            if it % CHECK_EVERY == 0 and not bool((r_norm > tol).any()):
                break
            active = r_norm > tol
            Ap = matvec(p)
            pAp = (p * Ap).sum(0)
            alpha = torch.where(active, rz / torch.where(pAp == 0, 1.0, pAp),
                                0.0)
            x = x + alpha * p
            r_new = r - alpha * Ap
            z_new = vcycle(h, r_new)
            rz_new = (r_new * z_new).sum(0)
            beta = torch.where(active, rz_new / torch.where(rz == 0, 1.0, rz),
                               0.0)
            p = torch.where(active, z_new + beta * p, p)
            r = torch.where(active, r_new, r)
            r_norm = torch.where(active, col_norm(r_new), r_norm)
            rz = torch.where(active, rz_new, rz)
            count += active
    return (x[:, 0] if squeeze else x), count.max()


def amg_pcg_solve(h: AmgHierarchy, b: torch.Tensor,
                  x0: torch.Tensor | None = None, tol: float = 1e-6,
                  max_iter: int = 100) -> torch.Tensor:
    """Preconditioned CG with the V-cycle as preconditioner, for b of shape
    (n,) or (n, k)."""
    return _amg_pcg(h, b, x0, tol, max_iter)[0]


class MultigridSolver:
    """AMG-PCG behind the solver surface: the hierarchy built once per
    epoch, cheap repeated solves.  ``iters`` holds the last solve's
    iteration count (a device scalar)."""

    method = "AMG"
    tier = "amg"

    def __init__(self, M: SparseCOO, tol: float = 1e-6,
                 coarse_limit: int = 4096, block_limit: int | None = None):
        self.tol = tol
        self.n = M.shape[0]
        self.h = build_hierarchy(M, coarse_limit=coarse_limit,
                                 block_limit=block_limit)
        self.iters = None

    def solve(self, b, x0=None):
        x, self.iters = _amg_pcg(self.h, b, x0, self.tol, 100)
        return x
