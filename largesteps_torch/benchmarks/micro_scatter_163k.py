"""Micro-benchmark at nefertiti's scale: the two halves of the backward's
chain and scatter, and the fixed-order segment sums.

    python -m largesteps_torch.benchmarks.micro_scatter_163k
        [--faces 327680] [--verts 163842] [--slots 847872] [--ch 18]
        [--device cuda]

Port of ``benchmarks/micro_scatter_163k.py``: one camera's slot table
(16 · 52,992 slots of 18 columns, ids random in [0, F]) summed into the
F + 1 faces, and the face → vertex incidence gather (each vertex's K = 7
corner rows of 6 columns).  The JAX script times the unsorted
``segment_sum``, a presorted variant (a gather by a rebin-time argsort,
then a sum over sorted ids) and the gather alone.  Here: ``index_add_``
(the unsorted sum; atomics on the card), :func:`largesteps_torch.ops.
segment.segment_sum` (a stable sort of the ids and a sum of each segment
in order: the fixed-order sum the step's glue makes), :class:`Segments`
(the same sum with the sort made once: the presorted variant), its gather
alone, the incidence take, and the sort of the slot ids alone.  Prints one
JSON line a leg, each naming the device.
"""
from __future__ import annotations

import argparse
import json

import torch

from .._device import resolve_device
from ..ops.segment import Segments, segment_sum
from . import device_name, time_ms

__all__ = ["main"]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--faces", type=int, default=327_680)
    ap.add_argument("--verts", type=int, default=163_842)
    ap.add_argument("--slots", type=int, default=16 * 52_992)
    ap.add_argument("--ch", type=int, default=18)
    ap.add_argument("--k", type=int, default=7)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    F, V, S, Q, K = args.faces, args.verts, args.slots, args.ch, args.k
    gen = torch.Generator().manual_seed(args.seed)
    ids = torch.randint(0, F + 1, (S,), generator=gen,
                        dtype=torch.int64).to(dev)
    table = torch.randn((S, Q), generator=gen).to(dev)
    idx = torch.randint(0, (F + 1) * 3, (V, K), generator=gen).to(dev)
    per_corner = torch.randn(((F + 1) * 3, 6), generator=gen).to(dev)
    seg = Segments(ids, F + 1)
    perm = seg.order

    def index_add():
        return torch.zeros((F + 1, Q), device=dev).index_add_(0, ids, table)

    legs = (
        ("segsum_index_add_ms", index_add),
        ("segsum_sorted_ms", lambda: segment_sum(table, ids, F + 1)),
        ("segsum_presorted_ms", lambda: seg.sum(table)),
        ("gather_alone_ms", lambda: table[perm]),
        ("incidence_take_ms",
         lambda: per_corner[idx.reshape(-1)].reshape(V, K, 6).sum(dim=1)),
        ("argsort_slots_ms", lambda: torch.sort(ids, stable=True)),
    )
    ref = index_add()
    scale = float(ref.abs().max()) + 1e-30
    base = {"device": device_name(dev), "faces": F, "verts": V, "slots": S,
            "ch": Q}
    lines = []
    for name, fn in legs:
        line = {**base, "metric": name,
                "value": time_ms(fn, dev, n=args.reps, warmup=2)}
        if name.startswith("segsum_"):
            line["rel_err_vs_index_add"] = float(
                (fn() - ref).abs().max()) / scale
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
