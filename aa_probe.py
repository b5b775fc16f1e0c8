"""How the antialias kernels' time grows with the length of the tiles' bins.

    python3 aa_probe.py [--root DIR]

Builds the main path's kernel inputs on the card (``chip_smoke.py``:
13 views at 256², cap 768), then times ``aa_fwd`` and ``aa_bwd`` (the
wrappers' whole call, CUDA events over 50 calls, twice) at that cap and at
cap 1536 with 0, 384 and 768 dummy live slots in front of every tile's bin.
A dummy slot holds face id F + 1, which no pixel has, so it changes no
result (checked: the forward's output stays bit-equal), only the length of
every bin.  A lookup whose cost grows with the bin shows as time that grows
with the dummies.

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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)), help="checkout whose largesteps_torch is timed")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("aa_probe: no CUDA device", file=sys.stderr)
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
    rbb, counts, fid, z, comp, d_out, res = (m[k] for k in (
        "rbb", "counts", "fid", "z", "comp", "d_out", "res"))
    cap = rbb.shape[3]
    base = K.aa_fwd(rbb, counts, fid, z, comp, res)
    for cap2, n in [(cap, 0)] + [(CAP, n) for n in DUMMIES]:
        rb2 = torch.zeros(rbb.shape[:3] + (cap2, 32), device=rbb.device)
        rb2[:, :, :, :n, 22] = float(m["n_faces"] + 1)
        rb2[:, :, :, n:n + cap] = rbb
        cn2 = (counts + n).contiguous()
        same = bool(torch.equal(K.aa_fwd(rb2, cn2, fid, z, comp, res), base))
        for rep in range(2):
            print(json.dumps({
                "package": os.path.dirname(largesteps_torch.__file__),
                "cap": cap2, "dummies": n, "rep": rep,
                "aa_fwd_ms": cs.time_ms(
                    lambda: K.aa_fwd(rb2, cn2, fid, z, comp, res), 50),
                "aa_bwd_ms": cs.time_ms(
                    lambda: K.aa_bwd(rb2, cn2, fid, z, comp, d_out, res), 50),
                "fwd_equal": same,
                "mean_live": float(counts.float().mean()) + n}), flush=True)
    print(cs.smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
