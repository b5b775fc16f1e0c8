"""Sparse matvec formulations and the large-mesh solver tiers at large V.

    python -m largesteps_torch.benchmarks.bench_matvec [--subdiv 7]
        [--iters 50] [--device cuda]

The counterpart of the JAX package's ``benchmarks/bench_matvec.py``, on
icosphere-``subdiv`` with λ = 19 and three seeded right-hand sides:

  coo    — gather, product and ``index_add`` (``core/sparse.py``)
  ell    — the padded-row, gather-only form (here only: it lost to the
           dense-block form in the JAX package and stays a probe)
  block  — RCM order and the dense-block batched product
           (``core/blocksp.py``)
  banded — the block-tridiagonal LDLᵀ solve with one refinement pass
           (``core/banded.py``)
  amg    — AMG-PCG on COO levels (``core/multigrid.py``), tol 1e-6

One JSON line a row: the matvecs' ms and their largest error against the
COO product relative to its largest entry; each solver's setup seconds,
ms a solve and relative residual ``‖M x − u‖ / ‖u‖``.  Times chain
``iters`` calls (the solves ``iters // 5`` and ``iters // 10``, at least
3), each call's input the last one's output, between two
``torch.cuda.synchronize()``; the first line names the card.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .._device import resolve_device
from ..core import multigrid
from ..core.banded import BandedSolver
from ..core.blocksp import BlockedOperator, permuted_coo, rcm_permutation
from ..core.geometry import compute_matrix
from ..core.sparse import coo_matvec
from ..ops.shapes import icosphere
from . import device_name

__all__ = ["EllMatvec", "chain_ms", "main"]


class EllMatvec:
    """``A @ x`` with rows padded to the largest row length K: a gather of
    (n, K) columns and a sum over K, no scatter."""

    def __init__(self, A):
        st = A.structure
        n = st.shape[0]
        counts = np.bincount(st.rows, minlength=n)
        K = int(counts.max())
        offsets = np.zeros(n + 1, np.int64)
        np.cumsum(counts, out=offsets[1:])
        k_idx = np.arange(K)[None, :]
        valid = k_idx < counts[:, None]                     # (n, K)
        slot = np.where(valid, offsets[:-1, None] + k_idx, 0)
        dev = A.device
        self.col = torch.as_tensor(np.where(valid, st.cols[slot], 0).reshape(
            -1).astype(np.int64), device=dev)
        self.w = A.vals.detach()[torch.as_tensor(slot, device=dev)] * \
            torch.as_tensor(valid, dtype=A.vals.dtype, device=dev)
        self.n, self.K = n, K

    def matvec(self, x):
        xi = x[self.col].reshape(self.n, self.K, x.shape[1])
        return (self.w[..., None] * xi).sum(dim=1)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def chain_ms(body, x0, iters, dev):
    """Milliseconds a call of ``body`` over ``iters`` chained calls, after
    one untimed call."""
    body(x0)
    _sync(dev)
    t0 = time.perf_counter()
    x = x0
    for _ in range(iters):
        x = body(x)
    _sync(dev)
    return (time.perf_counter() - t0) / iters * 1e3


def _rel_residual(M, x, u):
    return float(torch.linalg.norm(coo_matvec(M, x) - u) / torch.linalg.norm(u))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--subdiv", type=int, default=7)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rows = []

    def emit(**row):
        print(json.dumps(row), flush=True)
        rows.append(row)

    v, f = icosphere(args.subdiv)
    n = v.shape[0]
    M = compute_matrix(v, f, lambda_=19.0, device=dev)
    emit(device=device_name(dev), verts=n, nnz=M.nnz)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (n, 3)).astype(np.float32), device=dev)
    y = coo_matvec(M, x)
    scale = float(y.abs().max())

    ell = EllMatvec(M)
    emit(row="coo matvec",
         ms=chain_ms(lambda z: coo_matvec(M, z) * 1e-3, x, args.iters, dev),
         rel_err=0.0)
    emit(row="ell matvec",
         ms=chain_ms(lambda z: ell.matvec(z) * 1e-3, x, args.iters, dev),
         rel_err=float((ell.matvec(x) - y).abs().max()) / scale)

    st = M.structure
    perm, inv = rcm_permutation(st.rows, st.cols, n)
    n_pad = ((n + 127) // 128) * 128
    t0 = time.perf_counter()
    op = BlockedOperator(permuted_coo(M, inv, n_pad),
                         np.arange(n_pad, dtype=np.int64), 128)
    _sync(dev)
    setup_s = time.perf_counter() - t0
    xp = torch.zeros((n_pad, 3), device=dev)
    xp[:n] = x[torch.as_tensor(perm, device=dev)]
    yp = op.matvec(xp)[torch.as_tensor(inv, device=dev)]
    emit(row="block matvec",
         ms=chain_ms(lambda z: op.matvec(z) * 1e-3, xp, args.iters, dev),
         rel_err=float((yp - y).abs().max()) / scale, setup_s=setup_s,
         blocks=op.n_blocks, block_bytes=op.hbm_bytes)
    del op, xp, yp

    u = y
    t0 = time.perf_counter()
    banded = BandedSolver(M, refine=1)
    _sync(dev)
    setup_s = time.perf_counter() - t0
    ms = chain_ms(lambda z: banded.solve(u + 1e-6 * z), torch.zeros_like(u),
                  max(args.iters // 5, 3), dev)
    emit(row="banded LDLt solve", ms=ms, setup_s=setup_s,
         block=banded.B, blocks=banded.nb,
         rel_residual=_rel_residual(M, banded.solve(u), u))
    del banded

    t0 = time.perf_counter()
    h = multigrid.build_hierarchy(M)
    _sync(dev)
    setup_s = time.perf_counter() - t0
    ms = chain_ms(lambda z: multigrid.amg_pcg_solve(h, u, x0=z,
                                                    tol=1e-6) * 0.999,
                  torch.zeros_like(u), max(args.iters // 10, 3), dev)
    x_amg, iters = multigrid._amg_pcg(h, u, None, 1e-6, 100)
    emit(row="amg-pcg solve (coo)", ms=ms, setup_s=setup_s,
         iters_cold=int(iters), **multigrid.describe(h),
         rel_residual=_rel_residual(M, x_amg, u))
    return rows


if __name__ == "__main__":
    main()
