"""Reverse Cuthill-McKee ordering of a sparse matrix's graph (host).

Port of ``largesteps_tpu/core/blocksp.py:rcm_permutation`` (scipy and
numpy, copied).  The banded solver reorders the mesh system with it so that
its nonzeros lie within a band of O(√n).  ``BlockedOperator`` and
``permuted_coo`` belong to the block-AMG tier, which is still to port
(ROADMAP.md Queue 1, item 8).
"""
from __future__ import annotations

import numpy as np

__all__ = ["rcm_permutation"]


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
