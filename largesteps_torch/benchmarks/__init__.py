"""The port's micro-benchmarks, the counterparts of the JAX package's
``benchmarks/``.  Each runs as ``python -m largesteps_torch.benchmarks.
<name> [--device cuda]`` with its JAX script's sizes as flags:

* ``bench`` (``bench.py``'s metrics), ``bench_matvec``, ``bench_raster``;
* ``micro_scatter`` and ``probe_mosaic``, which hold the two kernels of
  those JAX scripts (``onehot_scatter``, ``probe_tile``) beside their plain
  versions, with their own launch counts;
* ``micro_rebin`` (the device rebin at 163k and its sorts),
  ``micro_scatter_163k`` (the chain and scatter halves at nefertiti, and
  the fixed-order segment sums against ``index_add_``), ``stage_times``
  (the fused pipe's stages at suzanne, the big pipe's per camera at
  nefertiti) and ``prof_suzanne_prebin`` (traced against prebinned bins on
  the main path), each printing JSON lines that name the device.

The JAX package's other scripts are covered by these entry points:

* ``profile_step.py``, ``profile_parts.py``, ``profile_fused.py``,
  ``prof_nefertiti.py``, ``prof_rebin.py``, ``probe_sustained.py``:
  ``python -m largesteps_torch.profiling [--large-f | --dense]`` (per-span
  host, self and stream time of the main, large-F and dense steps, rebins
  included, from the driver's own spans) and ``chip_smoke.py``'s
  ``large_f`` phase;
* ``ablate_pipe.py``: ``bench``'s ``render_fwdbwd_ms_ablate_*`` lines;
* ``micro_fwd.py``, ``micro_bwd.py``: the kernel rows of ``chip_smoke.py``
  (each kernel's ms, device ms, plain ms and bound at the main path's and
  nefertiti's shapes) and the ablate lines;
* ``prof_teaser_cull.py``: the driver's ``cull_backfaces``, which stays off
  as in JAX's teaser, and ``prof_suzanne_prebin``'s ``prebin_cull`` leg;
* ``probe_laxmap_vmem.py``: a probe of the TPU's scoped VMEM, which has no
  counterpart on the card.
"""
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
