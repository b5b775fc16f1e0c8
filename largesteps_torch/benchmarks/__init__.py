"""The rasterizer micro-benchmarks of the port, the counterparts of the JAX
package's ``benchmarks/bench_raster.py``, ``micro_scatter.py`` and
``probe_mosaic.py``.  Each runs as ``python -m
largesteps_torch.benchmarks.<name> [--device cuda]``; ``micro_scatter``
and ``probe_mosaic`` hold the two kernels of those JAX scripts
(``onehot_scatter``, ``probe_tile``) beside their plain versions, with
their own launch counts."""
from __future__ import annotations

import time

import torch

__all__ = ["time_ms", "device_name"]


def time_ms(fn, device, n=10, warmup=2) -> float:
    """Mean milliseconds of ``fn()`` over ``n`` calls after ``warmup``: by
    CUDA events on the card, by the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize(device)
        return a.elapsed_time(b) / n
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e3


def device_name(device) -> str:
    """The card's name, or ``cpu``: every printed time names its device."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
