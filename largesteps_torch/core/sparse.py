"""Sparse matrices: static-structure COO with a fixed-order matvec.

Port of ``largesteps_tpu/core/sparse.py``.  A matrix is a host-built static
structure (:class:`CooStructure`, numpy index arrays made once per topology
epoch, duplicates coalesced through a precomputed ``slot`` map) plus a value
tensor on the device.  The matvec sums ``vals * x[cols]`` into ``rows`` as
segments in a fixed order (``ops/segment.py``; the entries are sorted by
row), and its gradient in x into ``cols`` the same way: on the card
``index_add_`` adds in no fixed order, and runs would part.
:class:`CooMatvec` is the same product without the structure object, for
solvers that keep a matrix past its epoch's lifetime in the solver cache.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.segment import Segments

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

    def segments(self, name: str, device) -> Segments:
        """The entries as segments of their ``rows`` or ``cols``, or the
        input entries as segments of their coalesced ``slot``: built once
        a device and kept."""
        key = ("segments", name, str(device))
        if key not in self._dev:
            n = {"rows": self.shape[0], "cols": self.shape[1],
                 "slot": self.nnz}[name]
            self._dev[key] = Segments(getattr(self, name), n, device)
        return self._dev[key]

    def coalesce_values(self, raw_vals: torch.Tensor) -> torch.Tensor:
        """Sum duplicate-coordinate input values into coalesced slots, in
        input order."""
        return self.segments("slot", raw_vals.device).sum(raw_vals)


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


class _Matvec(torch.autograd.Function):
    """y = A x over the entries' row and column segments; the gradient in
    x is Aᵀ g over the column segments, in vals g[rows] · x[cols]."""

    @staticmethod
    def forward(ctx, vals, x, rows, cols):
        ctx.save_for_backward(vals, x)
        ctx.rows, ctx.cols = rows, cols
        return rows.sum(vals[:, None] * x[cols.ids])

    @staticmethod
    def backward(ctx, g):
        vals, x = ctx.saved_tensors
        gr = g[ctx.rows.ids]
        d_vals = (gr * x[ctx.cols.ids]).sum(dim=1) \
            if ctx.needs_input_grad[0] else None
        d_x = ctx.cols.sum(vals[:, None] * gr) \
            if ctx.needs_input_grad[1] else None
        return d_vals, d_x, None, None


def _matvec(rows, cols, vals, x):
    squeeze = x.ndim == 1
    y = _Matvec.apply(vals, x[:, None] if squeeze else x, rows, cols)
    return y[:, 0] if squeeze else y


def coo_matvec(A: SparseCOO, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` for dense x of shape (n,) or (n, k)."""
    st = A.structure
    return _matvec(st.segments("rows", x.device),
                   st.segments("cols", x.device), A.vals, x)


class CooMatvec:
    """``A @ x`` of a SparseCOO that keeps only its device index tensors and
    (detached) values, never its :class:`CooStructure`.  The solver cache
    (``core/parameterize.py``) drops a solver when the structure it is keyed
    on goes; a solver that held the structure would keep it, and itself,
    alive for good."""

    def __init__(self, A: SparseCOO):
        dev = A.device
        self.row_segments = A.structure.segments("rows", dev)
        self.col_segments = A.structure.segments("cols", dev)
        self.rows = self.row_segments.ids
        self.cols = self.col_segments.ids
        self.vals = A.vals.detach()
        self.shape = A.shape

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return _matvec(self.row_segments, self.col_segments, self.vals, x)
