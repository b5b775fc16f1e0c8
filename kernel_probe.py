"""What the micro-benchmarks' two kernels' time is made of, and their
measured variants.

    python3 kernel_probe.py [--root DIR]

On the card, prints one JSON line per measurement, then the card's name and
power limit:

* ``probe_tile`` on the main path's 208 tiles at the fitted cap (the slot
  plane, records and cotangent of ``chip_smoke.py``'s ``probe_cases``):
  the wrapper's call, the launcher alone on outputs made once, a fill of
  the fields (the card's floor for their 109 MB of stores) and, where the
  checkout has ``ls_probe_tile_items``, the kernel over its sums items
  alone and over its field items alone; CUDA events over 50 calls each,
  in the order a, b, ..., b, a, and the device time of the same calls by
  ``torch.profiler``.
* ``probe_tile`` on the JAX probe's one tile at cap 256: where the host's
  time goes in a call, by ``time.perf_counter`` over 2,000 repetitions of
  each piece (the checks, the output allocation, the stream lookup, the
  launcher's ctypes call with the launch), the wrapper's whole call on the
  host clock and by CUDA events, the kernel's own time by the profiler, and
  the library pair (``index_select`` + ``index_add_``).
* ``onehot_scatter`` at the main path's shape (13 × 65,536 rows of 32 into
  5,121 faces, seeded ids), at nefertiti's (847,872 × 18 into 327,681) and,
  where the checkout has ``face_ids``, on the main path's own traffic, and
  contended (13 × 65,536 rows of 32 into 64 faces): the wrapper and
  ``index_add_``, in turns, each with its device time.

``--root`` imports ``largesteps_torch`` from another checkout, so that two
versions of the kernels can be timed in one call on one card; what that
checkout lacks (the item launcher, ``face_ids``) is skipped.  Needs a
card.
"""
import argparse
import importlib.util
import json
import os
import sys
import time

REPS = 50
HOST_REPS = 2000


def emit(obj):
    print(json.dumps(obj), flush=True)


def host_us(fn, n=HOST_REPS):
    """Mean microseconds of ``fn()`` on the host clock (no synchronise)."""
    for _ in range(20):
        fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e6


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)), help="checkout whose largesteps_torch is timed")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    import largesteps_torch                    # the package under test
    from largesteps_torch import _cuda
    from largesteps_torch.benchmarks import micro_scatter as ms
    from largesteps_torch.benchmarks import probe_mosaic as pm
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(here, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    root = os.path.dirname(os.path.dirname(largesteps_torch.__file__))
    dev = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def symbol(name, sym):
        try:
            return _cuda.library(name, sym)
        except (AttributeError, KeyError):
            return None

    def timed(tag, fns):
        """Each fn in turns (a, b, b, a), CUDA events and profiler."""
        out = {k: [] for k in fns}
        order = list(fns) + list(fns)[::-1]
        for k in order:
            out[k].append(cs.time_ms(fns[k], REPS))
        row = {"probe": tag, "root": root}
        for k, fn in fns.items():
            row[f"{k}_ms"] = out[k]
            row[f"{k}_device_ms"] = cs.device_ms(fn, 20)
        emit(row)

    # probe_tile on the main path's tiles
    cases = cs.probe_cases(("probe_tile",))
    a = next(c[2] for c in cases if c[0] == "probe_tile"
             and c[1].startswith("main_path"))
    B, _, cap = a["recT"].shape
    fields = torch.empty((B, 32, 4096), device=dev)
    S = torch.empty((B, cap, 18), device=dev)
    ptrs = [t.data_ptr() for t in (a["slot"], a["recT"], a["g0"], fields, S)]
    launch = _cuda.library("probe_tile")
    fns = {"wrapper": lambda: pm.probe_tile(**a),
           "launcher": lambda: launch(*ptrs, B, cap, stream()),
           "fields_fill": lambda: fields.fill_(0.0)}
    items = symbol("probe_tile", "ls_probe_tile_items")
    if items is not None:
        fns["sums_items"] = lambda: items(*ptrs, B, cap, 0, B, stream())
        fns["field_items"] = lambda: items(*ptrs, B, cap, B, 4 * B, stream())
        emit({"probe": "probe_tile_grid",
              "grid": _cuda.launch_shape("probe_tile", B, cap)[:5]})
    timed(f"probe_tile_{B}x{cap}", fns)
    del a, fields, S

    # probe_tile on one tile: the host's share
    t = next(c[2] for c in cases if c[0] == "probe_tile"
             and c[1].startswith("seeded"))
    slot, recT, g0 = t["slot"], t["recT"], t["g0"]
    B, _, cap = recT.shape
    fields = torch.empty((B, 32, 4096), device=dev)
    S = torch.empty((B, cap, 18), device=dev)
    ptrs = [x.data_ptr() for x in (slot, recT, g0, fields, S)]
    raw = stream()
    n = B * 32 * 4096

    def one_buffer():
        o = torch.empty(n + B * cap * 18, dtype=torch.float32, device=dev)
        return (o.as_strided((B, 32, 4096), (32 * 4096, 4096, 1)),
                o.as_strided((B, cap, 18), (cap * 18, 18, 1), n))

    def dtype_checks():
        for x in (slot, recT, g0):
            if x.dtype != torch.float32 or not x.is_contiguous() \
                    or x.data_ptr() % 16:
                raise ValueError

    pieces = {
        "check_shapes_devices": lambda: pm._check(slot, recT, g0),
        "check_dtypes": dtype_checks,
        "two_torch_empty": lambda: (
            torch.empty((B, 32, 4096), dtype=torch.float32, device=dev),
            torch.empty((B, cap, 18), dtype=torch.float32, device=dev)),
        "one_buffer_two_views": one_buffer,
        "current_stream_dev": lambda: torch.cuda.current_stream(
            dev).cuda_stream,
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(0),
        "library_lookup": lambda: _cuda.library("probe_tile"),
        "ctypes_launch": lambda: launch(*ptrs, B, cap, raw),
        "data_ptr_x5": lambda: [x.data_ptr() for x in (slot, recT, g0,
                                                       fields, S)],
        "wrapper": lambda: pm.probe_tile(slot, recT, g0),
    }
    host = {}
    for k, fn in pieces.items():
        host[k] = host_us(fn)
        torch.cuda.synchronize()
    lib = cs._probe_library("probe_tile", t)
    emit({"probe": f"probe_tile_1x{cap}_host", "root": root,
          "host_us": host,
          "wrapper_ms": cs.time_ms(lambda: pm.probe_tile(slot, recT, g0),
                                   200),
          "library_ms": cs.time_ms(lib, 200),
          "launcher_ms": cs.time_ms(lambda: launch(*ptrs, B, cap, raw), 200),
          "device_ms": cs.device_ms(lambda: pm.probe_tile(slot, recT, g0),
                                    50),
          "library_device_ms": cs.device_ms(lib, 50)})

    # onehot_scatter against index_add_
    from largesteps_torch.render import pipeline
    kinds = ("onehot_scatter", "traffic") if hasattr(pipeline, "face_ids") \
        else ("onehot_scatter",)
    gen = torch.Generator().manual_seed(cs.SEED)
    contended = ("onehot_scatter", "contended", {
        "ids": torch.randint(0, 64, (13, 65_536), generator=gen,
                             dtype=torch.int32).to(dev),
        "m": torch.randn((13, 65_536, 32), generator=gen).to(dev),
        "n_faces": 64}, {})
    for c in [*cs.probe_cases(kinds), contended]:
        a = c[2]
        timed(f"onehot_scatter_{c[1]}", {
            "wrapper": lambda: ms.onehot_scatter(**a),
            "library": cs._probe_library("onehot_scatter", a)})
    print(cs.smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
