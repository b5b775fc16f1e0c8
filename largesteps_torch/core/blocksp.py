"""Reverse Cuthill-McKee ordering and the dense-block sparse matvec.

Port of ``largesteps_tpu/core/blocksp.py`` (``rcm_permutation``, scipy and
numpy, copied; ``BlockedOperator``; ``permuted_coo``).  The banded solver
reorders the mesh system with RCM so that its nonzeros lie within a band of
O(√n).  The block-AMG tier (``core/solvers.py:BlockAmgSolver``) runs its
large levels on :class:`BlockedOperator`: rows in groups of B = 128, every
nonzero (row group, column group) pair stored as a dense B × B block, and
the matvec three bulk operations with no per-element addressing::

    xb = x_grouped[col_group]                  # (NB, B, k) gather of groups
    yb = blocks @ xb                           # one batched product
    y  = segment sum of yb by row_group        # sorted, NB ≈ 8 a group

At 163,842 verts that is 10,213 blocks, 669 MB of float32.  The product
runs in full float32 (TF32 off), as the JAX package runs it at
``Precision.HIGHEST``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.segment import Segments
from .sparse import CooStructure, SparseCOO

__all__ = ["BlockedOperator", "permuted_coo", "rcm_permutation"]


def rcm_permutation(rows, cols, n):
    """(perm, inv): ``perm[i]`` is the old index of new row i, ``inv`` its
    inverse."""
    from scipy import sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    A = sp.coo_matrix((np.ones(len(rows), np.float32), (rows, cols)),
                      shape=(n, n)).tocsr()
    perm = np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True),
                      dtype=np.int64)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n)
    return perm, inv


class BlockedOperator:
    """Dense-block form of a sparse operator in the ordering ``inv_perm``
    (old row → new row), built on ``M``'s device.  ``matvec(xp)`` maps
    permuted (n_pad, k) to permuted (n_pad, k); ``n_blocks`` and
    ``hbm_bytes`` say what it holds."""

    def __init__(self, M: SparseCOO, inv_perm: np.ndarray, block: int = 128):
        st = M.structure
        n = st.shape[0]
        B = int(block)
        self.n = n
        self.block = B
        self.n_pad = ((n + B - 1) // B) * B
        G = self.n_pad // B
        self.groups = G

        r2 = inv_perm[st.rows.astype(np.int64)]
        c2 = inv_perm[st.cols.astype(np.int64)]
        pair = (r2 // B) * G + c2 // B
        uniq, pair_idx = np.unique(pair, return_inverse=True)
        dev = M.device
        idx = lambda a: torch.as_tensor(a.astype(np.int64), device=dev)
        self.n_blocks = len(uniq)
        self.blocks = torch.zeros((self.n_blocks, B, B), dtype=torch.float32,
                                  device=dev)
        self.blocks.index_put_((idx(pair_idx), idx(r2 % B), idx(c2 % B)),
                               M.vals.detach().to(torch.float32),
                               accumulate=True)
        # uniq is sorted by (row group, column group): row groups ascend
        # the blocks of each row group, summed in block order
        self.row_group = Segments(uniq // G, self.groups, dev)
        self.col_group = idx(uniq % G)
        self.hbm_bytes = self.n_blocks * B * B * 4

    def matvec(self, xp: torch.Tensor) -> torch.Tensor:
        """Permuted-space ``A @ x``; xp (n_in, k) or (n_in,) with n_in ≤
        n_pad: shorter inputs are zero-padded and the result cut back."""
        from .solvers import full_fp32

        squeeze = xp.ndim == 1
        if squeeze:
            xp = xp[:, None]
        n_in, k = xp.shape
        if n_in < self.n_pad:
            xp = torch.nn.functional.pad(xp, (0, 0, 0, self.n_pad - n_in))
        xb = xp.reshape(self.groups, self.block, k)[self.col_group]
        with full_fp32():
            yb = torch.bmm(self.blocks, xb)                  # (NB, B, k)
        yg = self.row_group.sum(yb)
        y = yg.reshape(self.n_pad, k)[:n_in]
        return y[:, 0] if squeeze else y


def permuted_coo(M: SparseCOO, inv_perm: np.ndarray,
                 n_pad: int | None = None) -> SparseCOO:
    """``M`` relabelled by a permutation (a new structure on the host; the
    values the same up to slot order), optionally padded to ``n_pad`` rows:
    the padding rows get an identity diagonal, so the operator stays SPD."""
    st = M.structure
    n = st.shape[0]
    vals = M.vals.detach().cpu().numpy().astype(np.float64)
    r2 = inv_perm[st.rows.astype(np.int64)]
    c2 = inv_perm[st.cols.astype(np.int64)]
    if n_pad is None:
        n_pad = n
    if n_pad > n:
        extra = np.arange(n, n_pad, dtype=np.int64)
        r2 = np.concatenate([r2, extra])
        c2 = np.concatenate([c2, extra])
        vals = np.concatenate([vals, np.ones(len(extra))])
    st2 = CooStructure(r2, c2, (n_pad, n_pad))
    v_sorted = np.zeros(st2.nnz, np.float64)
    np.add.at(v_sorted, st2.slot, vals)
    return SparseCOO(st2, torch.as_tensor(v_sorted.astype(np.float32),
                                          device=M.device))
