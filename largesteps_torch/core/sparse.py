"""Sparse matrices: static-structure COO with an ``index_add_`` matvec.

Port of ``largesteps_tpu/core/sparse.py``.  A matrix is a host-built static
structure (:class:`CooStructure`, numpy index arrays made once per topology
epoch, duplicates coalesced through a precomputed ``slot`` map) plus a value
tensor on the device.  The matvec is ``index_add_`` of ``vals * x[cols]``
into ``rows``.  :class:`CooMatvec` is the same product without the
structure object, for solvers that keep a matrix past its epoch's lifetime
in the solver cache.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["CooStructure", "SparseCOO", "CooMatvec", "from_coo",
           "coo_matvec"]


class CooStructure:
    """Static (host) sparsity structure of a coalesced COO matrix.

    rows, cols: int32 (nnz,) sorted by (row, col); ``slot[k]`` is the
    coalesced slot of input entry k; ``diag_slots`` (n,) the slot of (i, i)
    or -1 (square matrices only).
    """

    def __init__(self, rows, cols, shape):
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        n_rows, n_cols = shape
        lin = rows * n_cols + cols
        order = np.argsort(lin, kind="stable")
        uniq_lin, slot_of_sorted = np.unique(lin[order], return_inverse=True)
        slot = np.empty_like(slot_of_sorted)
        slot[order] = slot_of_sorted
        self.slot = slot.astype(np.int32)
        self.rows = (uniq_lin // n_cols).astype(np.int32)
        self.cols = (uniq_lin % n_cols).astype(np.int32)
        self.shape = (int(n_rows), int(n_cols))
        self.n_input = int(rows.shape[0])
        self._dev = {}
        if n_rows == n_cols:
            diag_lin = np.arange(n_rows, dtype=np.int64) * (n_cols + 1)
            pos = np.clip(np.searchsorted(uniq_lin, diag_lin), 0,
                          len(uniq_lin) - 1)
            self.diag_slots = np.where(uniq_lin[pos] == diag_lin, pos,
                                       -1).astype(np.int32)
        else:
            self.diag_slots = None

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    def index(self, name: str, device) -> torch.Tensor:
        """An index array (``rows``, ``cols``, ``slot``, ``diag_slots``) as
        an int64 tensor on ``device``, uploaded once and kept."""
        key = (name, str(device))
        if key not in self._dev:
            self._dev[key] = torch.as_tensor(
                getattr(self, name).astype(np.int64), device=device)
        return self._dev[key]

    def coalesce_values(self, raw_vals: torch.Tensor) -> torch.Tensor:
        """Sum duplicate-coordinate input values into coalesced slots."""
        out = torch.zeros(self.nnz, dtype=raw_vals.dtype,
                          device=raw_vals.device)
        return out.index_add_(0, self.index("slot", raw_vals.device),
                              raw_vals)


@dataclasses.dataclass
class SparseCOO:
    """Coalesced sparse COO matrix: static structure + value tensor."""

    structure: CooStructure
    vals: torch.Tensor

    @property
    def shape(self):
        return self.structure.shape

    @property
    def nnz(self):
        return self.structure.nnz

    @property
    def device(self):
        return self.vals.device

    def __matmul__(self, x):
        return coo_matvec(self, x)

    def todense(self) -> torch.Tensor:
        st = self.structure
        out = torch.zeros(self.shape, dtype=self.vals.dtype,
                          device=self.device)
        out[st.index("rows", self.device), st.index("cols", self.device)] = \
            self.vals
        return out

    def transpose(self) -> "SparseCOO":
        st = self.structure
        st_t = CooStructure(st.cols, st.rows, self.shape[::-1])
        # the values in the transposed (sorted) order
        lin_t = st.cols.astype(np.int64) * self.shape[0] + st.rows
        order = np.argsort(lin_t, kind="stable")
        return SparseCOO(st_t, self.vals[torch.as_tensor(order,
                                                         device=self.device)])

    def scale(self, s) -> "SparseCOO":
        return SparseCOO(self.structure, self.vals * s)

    def diagonal(self) -> torch.Tensor:
        """The (n,) diagonal, 0 where the structure has no diagonal entry."""
        if self.structure.diag_slots is None:
            raise ValueError("not square")
        ds = self.structure.index("diag_slots", self.device)
        return torch.where(ds < 0, 0.0, self.vals[ds.clamp(min=0)])

    def add_scaled_identity(self, diag_scale, self_scale=1.0) -> "SparseCOO":
        """``self_scale * A + diag_scale * I`` (the structure must hold the
        full diagonal, which mesh Laplacians always do)."""
        ds = self.structure.diag_slots
        if ds is None or (ds < 0).any():
            raise ValueError("structure does not contain the full diagonal")
        vals = self.vals * self_scale
        vals[self.structure.index("diag_slots", self.device)] += diag_scale
        return SparseCOO(self.structure, vals)


def from_coo(rows, cols, raw_vals: torch.Tensor, shape) -> SparseCOO:
    """Coalesced SparseCOO from (possibly duplicated) host coordinates."""
    st = CooStructure(rows, cols, shape)
    return SparseCOO(st, st.coalesce_values(raw_vals))


def _matvec(rows, cols, vals, n_rows, x):
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    y = torch.zeros((n_rows, x.shape[1]), dtype=x.dtype, device=x.device)
    y = y.index_add(0, rows, vals[:, None] * x[cols])
    return y[:, 0] if squeeze else y


def coo_matvec(A: SparseCOO, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` for dense x of shape (n,) or (n, k)."""
    st = A.structure
    return _matvec(st.index("rows", x.device), st.index("cols", x.device),
                   A.vals, A.shape[0], x)


class CooMatvec:
    """``A @ x`` of a SparseCOO that keeps only its device index tensors and
    (detached) values, never its :class:`CooStructure`.  The solver cache
    (``core/parameterize.py``) drops a solver when the structure it is keyed
    on goes; a solver that held the structure would keep it, and itself,
    alive for good."""

    def __init__(self, A: SparseCOO):
        dev = A.device
        self.rows = A.structure.index("rows", dev)
        self.cols = A.structure.index("cols", dev)
        self.vals = A.vals.detach()
        self.shape = A.shape

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return _matvec(self.rows, self.cols, self.vals, self.shape[0], x)
