"""Micro-benchmark: segment-sum strategies for the rasterizer backward.

    python -m largesteps_torch.benchmarks.micro_scatter [--cams 13]
        [--px 65536] [--faces 5121] [--ch 32] [--device cuda]

Port of ``benchmarks/micro_scatter.py``.  The backward reduces per-pixel
rows keyed by face id (13 cameras × 256² at the defaults) into per-face
sums.  Legs, as the JAX script's: ``index_add_`` (JAX's ``segment_sum``);
sort, cumsum and a boundary gather; the hand-written kernel
:func:`onehot_scatter` (``csrc/onehot_scatter.cu``, JAX's Pallas one-hot
matmul); their relative errors; and the binning's stable argsort against
``topk``.  The nefertiti shape of ``benchmarks/micro_scatter_163k.py`` is
``--cams 1 --px 847872 --faces 327681 --ch 18``.
"""
from __future__ import annotations

import argparse
import functools

import torch

from .. import _cuda
from .._device import resolve_device
from . import device_name, time_ms

__all__ = ["onehot_scatter", "onehot_scatter_plain", "LAUNCHES", "main"]

LAUNCHES = {"onehot_scatter": 0}


def _check(ids, m, n_faces):
    if ids.dim() != 2 or m.dim() != 3 or tuple(m.shape[:2]) != tuple(
            ids.shape):
        raise ValueError(f"onehot_scatter: ids (C, P) and m (C, P, ch), got "
                         f"{tuple(ids.shape)} and {tuple(m.shape)}")
    if ids.device != m.device:
        raise ValueError(f"onehot_scatter: ids on {ids.device}, m on "
                         f"{m.device}")
    if n_faces < 0:
        raise ValueError(f"onehot_scatter: n_faces {n_faces} < 0")


def onehot_scatter(ids, m, n_faces: int):
    """The segment sum ``out[f] = Σ m[c, p, :]`` over the (c, p) with
    ``ids[c, p] == f``, summed over cameras: ids (C, P) int32, m (C, P, ch)
    float32 → (n_faces, ch) float32.  Ids outside [0, n_faces) add nothing.
    The name is the JAX kernel's, which computes this sum as a one-hot
    matmul.  On the card the kernel (a launch counted in ``LAUNCHES``), on
    the CPU :func:`onehot_scatter_plain`."""
    _check(ids, m, n_faces)
    if m.device.type == "cpu":
        return onehot_scatter_plain(ids, m, n_faces)
    if m.device.type != "cuda":
        raise ValueError(f"onehot_scatter: unsupported device {m.device}")
    if ids.dtype != torch.int32 or m.dtype != torch.float32 \
            or not ids.is_contiguous() or not m.is_contiguous() \
            or m.data_ptr() % 16:
        raise ValueError("onehot_scatter: contiguous int32 ids and float32 m "
                         "that starts on 16 bytes, on the card")
    C, P, ch = m.shape
    # the launcher zeroes the output on the stream
    out = torch.empty((n_faces, ch), dtype=torch.float32, device=m.device)
    err = _launcher()(ids.data_ptr(), m.data_ptr(), out.data_ptr(), C * P,
                      ch, n_faces, _cuda.stream(m.device))
    _cuda.check("onehot_scatter", err)
    LAUNCHES["onehot_scatter"] += 1
    return out


@functools.cache
def _launcher():
    """onehot_scatter's loaded launcher, looked up once."""
    return _cuda.library("onehot_scatter")


def onehot_scatter_plain(ids, m, n_faces: int):
    """Plain PyTorch version of :func:`onehot_scatter`: ``index_add_`` of
    the entries whose ids are in range into zeros."""
    _check(ids, m, n_faces)
    ch = m.shape[-1]
    flat = ids.reshape(-1).to(torch.int64)
    rows = m.reshape(-1, ch)
    ok = (flat >= 0) & (flat < n_faces)
    out = torch.zeros((n_faces, ch), dtype=torch.float32, device=m.device)
    return out.index_add_(0, flat[ok], rows[ok].to(torch.float32))


def sort_cumsum(ids, m, n_faces: int):
    """The segment sum by a sort of the ids, a cumsum of the sorted rows
    and a gather at the segments' bounds (the JAX script's leg b)."""
    ch = m.shape[-1]
    i = ids.reshape(-1)
    order = torch.argsort(i)
    si = i[order]
    cs = torch.cumsum(m.reshape(-1, ch)[order], dim=0)
    cs = torch.cat([cs.new_zeros(1, ch), cs])
    bounds = torch.searchsorted(
        si, torch.arange(n_faces + 1, dtype=si.dtype, device=si.device))
    return cs[bounds[1:]] - cs[bounds[:-1]]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cams", type=int, default=13)
    ap.add_argument("--px", type=int, default=65536)
    ap.add_argument("--faces", type=int, default=5121)
    ap.add_argument("--ch", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    C, P, F, ch = args.cams, args.px, args.faces, args.ch
    print(f"device={device_name(dev)} C={C} P={P} F={F} ch={ch}", flush=True)
    gen = torch.Generator().manual_seed(args.seed)
    ids = torch.randint(0, F, (C, P), generator=gen,
                        dtype=torch.int32).to(dev)
    m = torch.randn((C, P, ch), generator=gen).to(dev)
    t = lambda fn: time_ms(fn, dev, n=args.reps, warmup=3)
    out = {"device": device_name(dev), "shape": [C, P, F, ch]}

    def seg():
        return torch.zeros((F, ch), device=dev).index_add_(
            0, ids.reshape(-1).to(torch.int64), m.reshape(-1, ch))
    r_seg = seg()
    out["index_add_ms"] = t(seg)
    print(f"index_add_ (segment_sum): {out['index_add_ms']:8.3f} ms",
          flush=True)
    r_sort = sort_cumsum(ids, m, F)
    out["sort_cumsum_ms"] = t(lambda: sort_cumsum(ids, m, F))
    print(f"sort+cumsum:              {out['sort_cumsum_ms']:8.3f} ms",
          flush=True)
    r_oh = onehot_scatter(ids, m, F)
    out["onehot_scatter_ms"] = t(lambda: onehot_scatter(ids, m, F))
    label = "cuda onehot_scatter" if dev.type == "cuda" \
        else "onehot_scatter (plain)"
    print(f"{label + ':':26s}{out['onehot_scatter_ms']:8.3f} ms", flush=True)

    scale = float(r_seg.abs().max()) + 1e-9
    out["rel_err_onehot"] = float((r_oh - r_seg).abs().max()) / scale
    out["rel_err_sort"] = float((r_sort - r_seg).abs().max()) / scale
    print(f"rel err onehot={out['rel_err_onehot']:.2e} "
          f"sort={out['rel_err_sort']:.2e}", flush=True)

    # binning: the stable argsort of a tile's overlap flags, against topk
    T, cap = 256, 192
    ov = torch.rand((C, T, F - 1), generator=gen).to(dev) < 0.03
    not_ov = (~ov).to(torch.uint8)
    out["bin_argsort_ms"] = t(
        lambda: torch.sort(not_ov, dim=-1, stable=True)[1][..., :cap])
    print(f"bin argsort:              {out['bin_argsort_ms']:8.3f} ms",
          flush=True)
    keyed = torch.where(ov, -torch.arange(F - 1, dtype=torch.int32,
                                          device=dev),
                        torch.tensor(-2 ** 30, dtype=torch.int32, device=dev))
    out["bin_topk_ms"] = t(lambda: torch.topk(keyed, cap, dim=-1)[0])
    print(f"bin topk:                 {out['bin_topk_ms']:8.3f} ms",
          flush=True)
    return out


if __name__ == "__main__":
    main()
