"""Probe: one tile's owner gather and per-slot sums, held against a numpy
oracle and timed.

    python -m largesteps_torch.benchmarks.probe_mosaic [--cap 256]
        [--tiles 1] [--device cuda]

Port of ``benchmarks/probe_mosaic.py``, which probed the TPU compiler's
support and cost for the primitives of the raster kernels: a (32, 128)
slot plane, the winner's record column per pixel (``fields = recT @
onehot(slot)``) and per-slot sums of 18 planes (``S = onehot @ gᵀ``,
``g_i = g0 · (i + 1)``).  Here the hand-written kernel :func:`probe_tile`
(``csrc/probe_tile.cu``) computes the same function for a batch of tiles;
the defaults are the JAX probe's one tile at cap 256.
"""
from __future__ import annotations

import argparse
import functools

import numpy as np
import torch

from .. import _cuda
from .._device import resolve_device
from . import device_name, time_ms

__all__ = ["probe_tile", "probe_tile_plain", "LAUNCHES", "main", "CAP",
           "SMEM_MAX"]

CAP = 256
P = 32 * 128
NS = 18                 # the per-slot sums
SMEM_MAX = 232_448      # shared memory a block of the H100 may take
LAUNCHES = {"probe_tile": 0}


def _check(slot, recT, g0):
    B = slot.shape[0]
    if slot.shape != (B, 32, 128) or g0.shape != (B, 32, 128) \
            or recT.dim() != 3 or recT.shape[:2] != (B, 32):
        raise ValueError(f"probe_tile: slot and g0 (B, 32, 128), recT "
                         f"(B, 32, cap); got {tuple(slot.shape)}, "
                         f"{tuple(recT.shape)}, {tuple(g0.shape)}")
    if not slot.device == recT.device == g0.device:
        raise ValueError("probe_tile: tensors on several devices")


def probe_tile(slot, recT, g0):
    """Per tile b: ``fields[b, r, p] = recT[b, r, slot[b, p]]`` (0 where the
    slot names no column: −1, out of range or not integral) and ``S[b, c,
    i] = Σ_{p: slot[b, p] = c} g0[b, p] · (i + 1)`` for i < 18.  slot
    (B, 32, 128), recT (B, 32, cap), g0 (B, 32, 128), float32 → (fields
    (B, 32, 4096), S (B, cap, 18)).  On the card the kernel (a launch
    counted in ``LAUNCHES``; cap at most 1,162; tensors that start on 16
    bytes), on the CPU :func:`probe_tile_plain`."""
    _check(slot, recT, g0)
    if slot.device.type == "cpu":
        return probe_tile_plain(slot, recT, g0)
    if slot.device.type != "cuda":
        raise ValueError(f"probe_tile: unsupported device {slot.device}")
    for name, t in (("slot", slot), ("recT", recT), ("g0", g0)):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"probe_tile: {name} must be a contiguous "
                             f"float32 tensor that starts on 16 bytes")
    B, _, cap = recT.shape
    # the contract's cap limit: a tile's records and sums in one block's
    # shared memory, as the first design held them
    if (32 + NS) * cap * 4 > SMEM_MAX:
        raise ValueError(f"probe_tile: cap {cap} takes more shared memory "
                         f"than a block has")
    # one allocation for both outputs: each torch.empty costs more host
    # time than a strided view of one (kernel_probe.py, PERF.md)
    n = B * 32 * P
    out = torch.empty(n + B * cap * NS, dtype=torch.float32,
                      device=slot.device)
    fields = out.as_strided((B, 32, P), (32 * P, P, 1))
    S = out.as_strided((B, cap, NS), (cap * NS, NS, 1), n)
    err = _launcher()(slot.data_ptr(), recT.data_ptr(), g0.data_ptr(),
                      fields.data_ptr(), S.data_ptr(), B, cap,
                      _cuda.stream(slot.device))
    _cuda.check("probe_tile", err)
    LAUNCHES["probe_tile"] += 1
    return fields, S


@functools.cache
def _launcher():
    """probe_tile's loaded launcher, looked up once."""
    return _cuda.library("probe_tile")


def probe_tile_plain(slot, recT, g0):
    """Plain PyTorch version of :func:`probe_tile`: a gather of the named
    columns and an ``index_add_`` of the 18 planes."""
    _check(slot, recT, g0)
    B, _, cap = recT.shape
    s = slot.reshape(B, P)
    valid = (s >= 0.0) & (s < cap) & (s == torch.floor(s))
    col = torch.where(valid, s, 0.0).to(torch.int64)
    fields = torch.gather(recT, 2, col[:, None, :].expand(B, 32, P))
    fields = torch.where(valid[:, None, :], fields, 0.0)
    k = torch.arange(1, NS + 1, dtype=torch.float32, device=slot.device)
    g = g0.reshape(B, P, 1) * k                           # (B, P, 18)
    flat = torch.arange(B, device=slot.device)[:, None] * cap + col
    S = torch.zeros((B * cap, NS), dtype=torch.float32, device=slot.device)
    S.index_add_(0, flat[valid], g[valid])
    return fields, S.reshape(B, cap, NS)


def oracle(slot, recT, g0):
    """The JAX probe's numpy oracle, tile by tile: one-hot products."""
    fields, S = [], []
    cap = recT.shape[-1]
    for s, r, g in zip(slot, recT, g0):
        oh = (np.arange(cap)[:, None] == s.reshape(-1)[None, :]).astype(
            np.float32)
        fields.append(r @ oh)
        gg = np.stack([g.reshape(-1) * np.float32(i + 1.0)
                       for i in range(NS)], axis=0)
        S.append(oh @ gg.T)
    return np.stack(fields), np.stack(S)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cap", type=int, default=CAP)
    ap.add_argument("--tiles", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    B, cap = args.tiles, args.cap
    rng = np.random.default_rng(args.seed)
    slot = rng.integers(-1, cap, (B, 32, 128)).astype(np.float32)
    recT = rng.standard_normal((B, 32, cap)).astype(np.float32)
    g0 = rng.standard_normal((B, 32, 128)).astype(np.float32)
    up = lambda a: torch.as_tensor(a, device=dev)
    st, rt, gt = up(slot), up(recT), up(g0)
    fields, S = probe_tile(st, rt, gt)
    fields_o, S_o = oracle(slot, recT, g0)
    out = {"device": device_name(dev), "tiles": B, "cap": cap,
           "fields_max_err": float(np.abs(fields.cpu().numpy()
                                          - fields_o).max()),
           "S_max_err": float(np.abs(S.cpu().numpy() - S_o).max()),
           "S_max": float(np.abs(S_o).max())}
    print(f"device={out['device']} tiles={B} cap={cap}")
    print("fields max err:", out["fields_max_err"])
    print("S max err:", out["S_max_err"], "of max", out["S_max"])
    out["us_per_call"] = time_ms(lambda: probe_tile(st, rt, gt), dev,
                                 n=args.reps) * 1e3
    print(f"per-call: {out['us_per_call']:.1f} us  ({B} tile(s) at "
          f"cap={cap})", flush=True)
    return out


if __name__ == "__main__":
    main()
