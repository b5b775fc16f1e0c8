"""Differential parameterization: u = M v and its cached inverse.

Port of ``largesteps_tpu/core/parameterize.py``.  One solver is cached per
matrix structure and method (``"Cholesky"``, ``"CholeskyHost"``, ``"CG"``,
``"AMG"``): the key is the identity of the ``CooStructure`` and a weakref
on it drops the entry when the structure goes (a remesh makes a new one),
so no solver may hold the structure.
"""
from __future__ import annotations

import weakref

from .multigrid import MultigridSolver
from .solvers import (CholeskyHostSolver, CholeskySolver,
                      ConjugateGradientSolver, solve)
from .sparse import SparseCOO, coo_matvec

__all__ = ["to_differential", "from_differential", "clear_cache",
           "get_solver"]

_cache: dict = {}


def _cache_put(key, value, structure):
    def _cleanup(_wr):
        _cache.pop(key, None)

    _cache[key] = (value, weakref.ref(structure, _cleanup))


def clear_cache():
    """Drop every cached solver."""
    _cache.clear()


def to_differential(M: SparseCOO, v):
    """u = M v, summed on the host for a card's tensors and moved back.  On
    the card ``index_add_`` adds with float atomics, so that u, the start of
    the optimization, differed in its last bits from run to run and from
    rank to rank, and the optimizer grows such a difference into a
    different fit; the host's sum is the same in every run."""
    if v.device.type == "cpu":
        return coo_matvec(M, v)
    host = SparseCOO(M.structure, M.vals.cpu())
    return coo_matvec(host, v.cpu()).to(v.device)


def get_solver(M: SparseCOO, method: str = "Cholesky"):
    """Look up or build the cached solver for M."""
    key = (id(M.structure), method)
    if key in _cache:
        return _cache[key][0]
    if method == "Cholesky":
        slv = CholeskySolver(M)
    elif method == "CholeskyHost":
        slv = CholeskyHostSolver(M)
    elif method == "CG":
        slv = ConjugateGradientSolver(M)
    elif method == "AMG":
        slv = MultigridSolver(M)
    else:
        raise ValueError(f"Unknown solver type '{method}'.")
    _cache_put(key, slv, M.structure)
    return slv


def from_differential(M: SparseCOO, u, method: str = "Cholesky",
                      guess_fwd=None, guess_bwd=None):
    """v = M⁻¹ u, differentiable, with the solver cached per structure; the
    guesses warm-start the iterative solvers' forward and backward solves."""
    return solve(get_solver(M, method), u, guess_fwd, guess_bwd)
