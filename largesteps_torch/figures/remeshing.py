"""The remeshing experiment on the port: the cranium scene, four legs at
the reference's equal-time step counts (``figures/remeshing/
generate_data.py``; reference figures/remeshing/generate_data.py:19-45).

    python -m largesteps_torch.figures.remeshing [--quick] [--only base]
        [--device cuda]

Boost 3, lr 1e-2, l1, α = 0.95.  ``reg``: Adam on the coordinates with a
bilaplacian weight of 0.16, 1,890 steps; ``base``: AdamUniform without
remeshing, 1,800 steps; ``remesh_middle``: a remesh at step 750, 1,630
steps; ``remesh_start``: a remesh before the first step, 1,500 steps.
``--quick`` runs 60 steps a leg and moves the middle remesh to step 20.
"""
from __future__ import annotations

from .common import cli, run

__all__ = ["SCENE", "COMMON", "METHODS", "legs", "main"]

SCENE = "cranium"
COMMON = {"boost": 3, "step_size": 1e-2, "loss": "l1", "alpha": 0.95}
METHODS = [
    ("reg", {"smooth": False, "optimizer": "Adam", "reg": 0.16,
             "steps": 1890, "remesh": -1}),
    ("base", {"smooth": True, "optimizer": "AdamUniform",
              "steps": 1800, "remesh": -1}),
    ("remesh_middle", {"smooth": True, "optimizer": "AdamUniform",
                       "steps": 1630, "remesh": 750}),
    ("remesh_start", {"smooth": True, "optimizer": "AdamUniform",
                      "steps": 1500, "remesh": 0}),
]


def legs(quick=False):
    """The four legs: [(name, driver params)]."""
    out = []
    for name, m in METHODS:
        params = {**COMMON, **m}
        if quick:
            params["steps"] = 60
            if params["remesh"] == 750:
                params["remesh"] = 20
        out.append((name, params))
    return out


def main(argv=None):
    args = cli(argv, __doc__.split("\n\n")[0])
    out = {}
    for name, params in legs(args.quick):
        if args.only and name != args.only:
            continue
        out[name] = run(name, SCENE, params, "remeshing",
                        device=args.device)[1]
    return out


if __name__ == "__main__":
    main()
