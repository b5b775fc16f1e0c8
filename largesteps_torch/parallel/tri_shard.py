"""Edge-sharded solver math and vertex-sharded gradient reduction.

Port of ``largesteps_tpu/parallel/tri_shard.py``:

* the CG solve's matvec ``sum(vals · x[cols])`` by rows, with the
  Laplacian's nonzeros cut into one slice a rank (:class:`EdgeShards`): a
  rank sums its slice's contributions into a partial (n, k) product, and
  one all-reduce of the partials gives every rank the same product
  (:func:`sharded_coo_matvec`, :func:`sharded_cg_solve`,
  :class:`ShardedCGSolver`);
* the face → vertex gradient gather with the vertex rows cut into one
  block a rank, reassembled by one all-gather
  (:func:`sharded_vertex_gather`).

The vectors of CG are replicated: every rank holds the same (n, k) ``x``,
``r`` and ``p``, so the norms and the stopping test
(``core/solvers.py``'s sums of squares, tested every ``CHECK_EVERY``
iterations) are the same on every rank, bit for bit, and so is the
decision to stop: the ranks' replicated work before a solve (the normals,
the vertex gathers' backward) adds in a fixed order on the card
(``ops/segment.py``), so every rank starts from the same right-hand side
and guess.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.solvers import CHECK_EVERY, col_norm, full_fp32
from ..core.sparse import SparseCOO
from .distributed import Mesh, all_gather, all_reduce

__all__ = ["EdgeShards", "sharded_coo_matvec", "sharded_cg_solve",
           "ShardedCGSolver", "sharded_vertex_gather"]


class EdgeShards:
    """This rank's slice of a CooStructure's nonzeros.

    The nonzeros (sorted by row) are cut into ``n_shards`` slices of about
    equal length at row boundaries, so that each row's entries lie in one
    slice: a row's partial product is then its whole sum on one rank and
    0.0 on the others, and the all-reduce gives the unsharded matvec's
    bits.  The slices are padded to the longest with sentinel entries at
    row and column ``n`` (a row that is dropped); ``rows`` and ``cols`` are
    all of them (n_shards, S) on the host, ``index`` this rank's on the
    device.  Built once a topology epoch, as the structure is."""

    def __init__(self, structure, n_shards: int, shard: int = 0,
                 device=None):
        nnz = structure.nnz
        self.n = structure.shape[0]
        self.n_shards, self.shard = int(n_shards), int(shard)
        rows = structure.rows.astype(np.int64)
        cuts = [0] + [int(np.searchsorted(rows, rows[s * nnz // n_shards]))
                      for s in range(1, self.n_shards)] + [nnz]
        self.cuts = cuts
        S = max(max(b - a for a, b in zip(cuts, cuts[1:])), 1)
        self.rows = np.full((self.n_shards, S), self.n, np.int64)
        self.cols = np.full((self.n_shards, S), self.n, np.int64)
        for s in range(self.n_shards):
            a, b = cuts[s], cuts[s + 1]
            self.rows[s, :b - a] = rows[a:b]
            self.cols[s, :b - a] = structure.cols[a:b]
        self.S = S
        as_t = lambda a: torch.as_tensor(a[self.shard], dtype=torch.int64,
                                         device=device)
        # the sentinel column reads row n - 1, times a zero value; the
        # slice's rows are sorted, so its sums are segments of them
        self.index = (as_t(np.minimum(self.cols, self.n - 1)),
                      torch.as_tensor(np.bincount(self.rows[self.shard],
                                                  minlength=self.n + 1),
                                      device=device))

    def local_vals(self, vals: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the (padded) value vector."""
        v = vals[self.cuts[self.shard]:self.cuts[self.shard + 1]]
        if v.shape[0] < self.S:
            v = torch.cat([v, v.new_zeros(self.S - v.shape[0])])
        return v


def _local_matvec(index, vals, x, n):
    """The partial product of one slice, each row's entries added in order
    (``ops/segment.py``); the sentinel row n is dropped."""
    cols, lengths = index
    return torch.segment_reduce(vals[:, None] * x[cols], "sum",
                                lengths=lengths, axis=0, unsafe=True)[:n]


def _shards(M, mesh, shards):
    if shards is not None:
        return shards
    return EdgeShards(M.structure, mesh.size, mesh.rank, M.device)


def sharded_coo_matvec(M: SparseCOO, x: torch.Tensor, mesh: Mesh,
                       shards: EdgeShards | None = None) -> torch.Tensor:
    """``M @ x`` with the nonzeros sharded over every rank of ``mesh``: x
    replicated (n,) or (n, k) → replicated, one all-reduce."""
    shards = _shards(M, mesh, shards)
    squeeze = x.ndim == 1
    xx = x[:, None] if squeeze else x
    y = all_reduce(_local_matvec(shards.index, shards.local_vals(M.vals), xx,
                                 shards.n))
    return y[:, 0] if squeeze else y


def _sharded_cg(shards, vals, b, x0, tol, max_iter):
    """(x, iterations as a device scalar): ``core/solvers._cg`` with the
    sharded matvec."""
    n = shards.n

    def matvec(x):
        return all_reduce(_local_matvec(shards.index, vals, x, n))

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
            # replicated r_norm: every rank stops at the same iteration
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


def sharded_cg_solve(M: SparseCOO, b: torch.Tensor, mesh: Mesh, x0=None,
                     tol: float = 1e-5, max_iter: int = 10000,
                     shards: EdgeShards | None = None) -> torch.Tensor:
    """Batched CG (``core.solvers.cg_solve``'s math: per-column α and β,
    columns frozen at ``tol``) with the matvec's nonzeros sharded over every
    rank of ``mesh``; one all-reduce an iteration."""
    shards = _shards(M, mesh, shards)
    return _sharded_cg(shards, shards.local_vals(M.vals.detach()), b, x0,
                       tol, max_iter)[0]


class ShardedCGSolver:
    """:func:`sharded_cg_solve` behind the solver surface of
    ``core.solvers.solve`` (warm starts passed to ``solve``); ``iters`` is
    the last solve's iteration count (a device scalar).  It keeps the
    slice's index tensors and values, not the matrix's structure."""

    method = "CG"
    tier = "sharded_cg"

    def __init__(self, M: SparseCOO, mesh: Mesh, tol: float = 1e-5):
        self.mesh = mesh
        self.tol = tol
        self.n = M.shape[0]
        self.shards = _shards(M, mesh, None)
        self.vals = self.shards.local_vals(M.vals.detach())
        self.iters = None

    def solve(self, b, x0=None):
        x, self.iters = _sharded_cg(self.shards, self.vals, b, x0, self.tol,
                                    10000)
        return x


def sharded_vertex_gather(per_corner: torch.Tensor, incidence,
                          mesh: Mesh) -> torch.Tensor:
    """Face-table → per-vertex sums with the vertex rows sharded: each rank
    gathers its V/ranks rows of the padded incidence
    (``render.pipeline.build_incidence``), and one all-gather reassembles
    the replicated result.

    per_corner (C, F·3 + pad, Q) replicated, corner-major, its last row the
    zero sentinel; incidence (idx (V, K), mask (V, K)) on the host.
    Returns (C, V, Q): each vertex's incident corners summed."""
    idx, mask = (np.asarray(a) for a in incidence)
    V, K = idx.shape
    ndev = mesh.size
    pad = (-V) % ndev
    sentinel = per_corner.shape[1] - 1
    idx_p = np.pad(idx, ((0, pad), (0, 0)), constant_values=sentinel)
    mask_p = np.pad(mask, ((0, pad), (0, 0))).astype(np.float32)
    rows = (V + pad) // ndev
    mine = slice(mesh.rank * rows, (mesh.rank + 1) * rows)
    dev = per_corner.device
    il = torch.as_tensor(idx_p[mine], dtype=torch.int64, device=dev)
    ml = torch.as_tensor(mask_p[mine], device=dev)
    g = per_corner[:, il.reshape(-1)].reshape(per_corner.shape[0], rows, K,
                                              per_corner.shape[-1])
    dv = (g * ml[None, :, :, None]).sum(dim=2)          # (C, V/ranks, Q)
    return torch.cat(all_gather(dv), dim=1)[:, :V]
