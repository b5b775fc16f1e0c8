"""Differential parameterization: u = M v and its cached inverse.

Port of ``largesteps_tpu/core/parameterize.py``.  One solver is cached per
matrix structure: the key is the identity of the ``CooStructure`` and a
weakref on it drops the entry when the structure goes (a remesh makes a new
one).
"""
from __future__ import annotations

import weakref

from .solvers import CholeskyHostSolver, CholeskySolver, solve
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
    """u = M v."""
    return coo_matvec(M, v)


def get_solver(M: SparseCOO, method: str = "Cholesky"):
    """Look up or build the cached solver for M."""
    key = (id(M.structure), method)
    if key in _cache:
        return _cache[key][0]
    if method == "Cholesky":
        slv = CholeskySolver(M)
    elif method == "CholeskyHost":
        slv = CholeskyHostSolver(M)
    elif method in ("CG", "AMG"):
        raise NotImplementedError(
            f"solver {method!r} is not ported yet (ROADMAP.md Queue 1, item "
            f"3: CG and the AMG solvers)")
    else:
        raise ValueError(f"Unknown solver type '{method}'.")
    _cache_put(key, slv, M.structure)
    return slv


def from_differential(M: SparseCOO, u, method: str = "Cholesky"):
    """v = M⁻¹ u, differentiable, with the solver cached per structure."""
    return solve(get_solver(M, method), u)
