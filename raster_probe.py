"""What the raster kernels' time is made of, at the main path's inputs.

    python3 raster_probe.py [--root DIR]

Builds the main path's kernel inputs on the card (``chip_smoke.py``:
13 views at 256², cap 768), then times each wrapper's whole call (CUDA
events over 50 calls, twice):

* ``raster_fwd`` at that cap, and at cap 1536 with n = 0, 384 and 768 dummy
  live slots in front of every tile's bin, of two sorts.  A ``norow`` dummy
  has an empty y-range (ymin 1e9, ymax -1e9): a y-range test rejects it, so
  it costs the scan of the bin and its staging.  A ``nopixel`` dummy has a
  y-range over the whole image and q0 = -1 everywhere (q0c = -1, its other
  edge coefficients 0): it passes the y-range test and covers nothing, so
  a kernel that tests it pixel by pixel pays full z-tests for it.  Checked:
  u, v, z, fid and the colour planes stay bit-equal to the run without
  dummies, and every covered pixel's slot moves by exactly n.
* ``raster_bwd`` on the main path's cotangents with three slot planes:
  ``real``; ``one``, where every covered pixel of a tile names the tile's
  slot 0 (all lanes of a warp add into one slot); ``spread``, where covered
  pixel p of a tile (p = row * 128 + column) names slot p mod the tile's
  count (no two pixels of a row segment of 32 share a slot); each at the
  fitted cap and at cap 9216, past the shared-memory table.  And the
  ``torch.zeros`` of an output of each cap alone.

``--root`` imports ``largesteps_torch`` from another checkout, so that two
versions of the kernels can be timed in one call on one card.  Prints one
JSON line per timing, then the card's name and power limit.  Needs a card.
"""
import argparse
import importlib.util
import json
import os
import sys

CAP = 1536
DUMMIES = (0, 384, 768)
BIG_CAP = 9216
REPS = 50


def _dummies(rfb, counts, n, kind):
    """The bins at cap CAP with n dummy slots of ``kind`` in front."""
    import torch
    rf = torch.zeros(rfb.shape[:3] + (CAP, 32), device=rfb.device)
    if kind == "norow":
        rf[..., :n, 12] = 1e9
        rf[..., :n, 13] = -1e9
    else:                                   # "nopixel"
        rf[..., :n, 2] = -1.0
        rf[..., :n, 12] = -1e9
        rf[..., :n, 13] = 1e9
    rf[..., :n, 14] = 1e9                   # a face id no pixel holds
    rf[..., n:n + rfb.shape[3], :] = rfb
    return rf, (counts + n).contiguous()


def _slot_planes(K, slot, counts):
    """The real slot plane, and the ``one`` and ``spread`` planes."""
    import torch
    st = K._to_tiles(slot)
    cnt = counts[..., None].to(st.dtype).clamp(min=1)
    p = torch.arange(st.shape[-1], device=st.device, dtype=st.dtype)
    cov = st >= 0
    one = torch.where(cov, 0.0, -1.0)
    spread = torch.where(cov, torch.remainder(p, cnt), -1.0)
    return {"real": slot, "one": K._from_tiles(one).contiguous(),
            "spread": K._from_tiles(spread).contiguous()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)), help="checkout whose largesteps_torch is timed")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("raster_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    import largesteps_torch                    # the package under test
    from largesteps_torch.render import kernels as K
    # this checkout's chip_smoke.py builds the inputs through that package
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    m = cs.main_path_inputs()
    rfb, rbb, counts, slot, d_col, res = (m[k] for k in (
        "rfb", "rbb", "counts", "slot", "d_col", "res"))
    zeros = torch.zeros_like(slot)
    package = os.path.dirname(largesteps_torch.__file__)
    cap = rfb.shape[3]
    ok = True

    def emit(rec, fn):
        for rep in range(2):
            print(json.dumps({"package": package, **rec, "rep": rep,
                              "ms": cs.time_ms(fn, REPS)}), flush=True)

    base = K.raster_fwd(rfb, counts, res)
    emit({"kernel": "raster_fwd", "cap": cap, "dummies": 0, "kind": "none",
          "mean_live": float(counts.float().mean())},
         lambda: K.raster_fwd(rfb, counts, res))
    for kind in ("norow", "nopixel"):
        for n in DUMMIES:
            rf, cn = _dummies(rfb, counts, n, kind)
            got = K.raster_fwd(rf, cn, res)
            same = all(torch.equal(got[i], base[i]) for i in (0, 1, 2, 3, 5,
                                                              6, 7))
            shifted = torch.equal(got[4], torch.where(base[4] >= 0,
                                                      base[4] + n, -1.0))
            ok = ok and same and shifted
            emit({"kernel": "raster_fwd", "cap": CAP, "dummies": n,
                  "kind": kind, "planes_equal": same,
                  "slot_shifted": shifted,
                  "mean_live": float(counts.float().mean()) + n},
                 lambda: K.raster_fwd(rf, cn, res))
            del rf, cn

    planes = _slot_planes(K, slot, counts)
    rb9 = torch.zeros(rbb.shape[:3] + (BIG_CAP, 32), device=rbb.device)
    rb9[..., :cap, :] = rbb
    for c, rb in ((cap, rbb), (BIG_CAP, rb9)):
        for name, sp in planes.items():
            emit({"kernel": "raster_bwd", "cap": c, "slots": name},
                 lambda: K.raster_bwd(rb, counts, sp, d_col, zeros, zeros,
                                      res))
        shape = rb.shape
        emit({"kernel": "zeros", "cap": c,
              "bytes": rb.numel() * rb.element_size()},
             lambda: torch.zeros(shape, device=rb.device))
    print(cs.smi(), flush=True)
    if not ok:
        print("raster_probe: dummies changed the forward's planes",
              file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
