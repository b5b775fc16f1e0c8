"""The multiscale experiment on the port: the dragon scene, 16,000 steps
with eight remeshes (``figures/multiscale/generate_data.py``; reference
figures/multiscale/generate_data.py:17-26).

    python -m largesteps_torch.figures.multiscale [--quick] [--device cuda]

lr 1e-1, l1, λ = 19, boost 3, remeshes at steps 500, 1,500, 3,000, 4,500,
7,000, 10,000, 12,000 and 14,000.  Each remesh halves the mean edge length,
about four times the faces, so on the stand-in scene (icosphere-4 to
start) the full schedule outgrows any card; ``--quick`` runs 120 steps with
remeshes at 40 and 80, which ends near 41k vertices (the banded solver and
host bins).
"""
from __future__ import annotations

from .common import cli, run

__all__ = ["SCENE", "PARAMS", "legs", "main"]

SCENE = "dragon"
PARAMS = {"steps": 16000, "smooth": True, "lambda": 19.0, "step_size": 1e-1,
          "loss": "l1", "boost": 3,
          "remesh": [500, 1500, 3000, 4500, 7000, 10000, 12000, 14000]}


def legs(quick=False):
    """The one leg: [(name, driver params)]."""
    params = dict(PARAMS)
    if quick:
        params.update(steps=120, remesh=[40, 80])
    return [("multiscale", params)]


def main(argv=None):
    args = cli(argv, __doc__.split("\n\n")[0])
    out = {}
    for name, params in legs(args.quick):
        if args.only and name != args.only:
            continue
        out[name] = run(name, SCENE, params, "multiscale",
                        device=args.device)[1]
    return out


if __name__ == "__main__":
    main()
