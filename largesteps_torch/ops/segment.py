"""Segment sums in a fixed order.

On the card ``index_add_`` and the backwards of ``torch.gather`` and
``index_select`` add with float atomics in the order the threads arrive,
so the same inputs can give sums that differ in their last bits, and two
runs of the driver on the card part from each other.  The sums here
sort the ids (a stable sort, so each segment keeps its entries in their
input order) and add each segment's entries in that order with
``torch.segment_reduce``, one sequential loop an output element: the same
bits on every run, and on the CPU the sums ``index_add_`` makes.

:class:`Segments` sorts a static id list once (faces into vertices, the
coalesced entries of a sparse matrix into its rows); :func:`segment_sum`
sorts the ids it is given (ids that change every step, as the slots of the
traced bins do); :func:`run_sums` adds runs of entries that already lie
together, in their order.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Segments", "segment_sum", "run_sums"]


def _reduce(values, order, lengths):
    """Each segment's entries of values (in ``order``, or as they stand
    where order is None) added in that order."""
    if order is not None:
        values = values[order]
    return run_sums(values, lengths)


def run_sums(values: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """The sums (len(lengths), ...) of consecutive runs of values, run k
    the next ``lengths[k]`` entries (int64, summing to len(values)), each
    added in its order; an empty run is 0."""
    return torch.segment_reduce(values, "sum", lengths=lengths, axis=0,
                                unsafe=True)


class Segments:
    """The segments of a static id list: entry k of a value array adds into
    row ``ids[k]`` of ``n`` rows (int64 in [0, n)).  ``ids`` (any shape,
    flattened) is sorted once, on the host for a numpy array, else on its
    device.

    ``sum(values)`` is the segment sum (n, ...) of values (len(ids), ...);
    ``gather(x)`` is ``x[ids]``, whose gradient is that segment sum (where
    ``torch.gather``'s and ``index_select``'s backwards add with atomics on
    the card).
    """

    def __init__(self, ids, n, device=None):
        if isinstance(ids, torch.Tensor):
            device = ids.device if device is None else device
            ids = ids.detach().reshape(-1).to(device=device,
                                              dtype=torch.int64)
            order, lengths = _sort(ids, n)
        else:
            ids = np.asarray(ids, dtype=np.int64).reshape(-1)
            order = np.argsort(ids, kind="stable")
            # ids sorted already (a matrix's rows) need no gather
            order = None if (order == np.arange(len(ids))).all() \
                else torch.as_tensor(order, device=device)
            lengths = torch.as_tensor(np.bincount(ids, minlength=n),
                                      device=device)
            ids = torch.as_tensor(ids, device=device)
        self.ids, self.order, self.lengths, self.n = ids, order, lengths, n

    def sum(self, values: torch.Tensor) -> torch.Tensor:
        return _reduce(values, self.order, self.lengths)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return _Gather.apply(x, self)


class _Gather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, seg):
        ctx.seg = seg
        return x[seg.ids]

    @staticmethod
    def backward(ctx, g):
        return ctx.seg.sum(g), None


def _sort(ids, n):
    """(the stable order of ids (int64 in [0, n)), each id's count), on
    the ids' device without a host sync."""
    sorted_ids, order = torch.sort(ids, stable=True)
    bounds = torch.searchsorted(
        sorted_ids, torch.arange(n + 1, device=ids.device, dtype=ids.dtype))
    return order, bounds[1:] - bounds[:-1]


def segment_sum(values: torch.Tensor, ids: torch.Tensor, n: int
                ) -> torch.Tensor:
    """The rows (n, ...) that the entries of values (len(ids), ...) add
    into at ``ids`` (int64 in [0, n)), each row's entries added in their
    order: a stable sort of ids, then :func:`torch.segment_reduce`."""
    return _reduce(values, *_sort(ids.reshape(-1), n))
