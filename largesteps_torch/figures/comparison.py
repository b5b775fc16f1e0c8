"""The comparison experiment on the port: six scenes × {ours,
laplacian-reg, bilaplacian-reg} at the reference's equal-time step counts,
the symmetric Hausdorff distance of each (``figures/comparison/
generate_data.py``; reference figures/comparison/generate_data.py:21-58).

    python -m largesteps_torch.figures.comparison [--quick] [--only suzanne]
        [--device cuda]

Boost 3, l1 loss, α = 0.95; ours is AdamUniform at each scene's step size,
the baselines Adam at 1e-2 with each scene's Laplacian or bilaplacian
weight, on the coordinates (no solve).  ``--quick`` runs suzanne, 50 steps
a leg.
"""
from __future__ import annotations

from .common import cli, run

__all__ = ["SCENES", "STEP_SIZES", "OURS_STEPS", "BASE_STEPS", "REGS_LAP",
           "REGS_BILAP", "COMMON", "legs", "main"]

# the reference's frozen equal-time step counts and weights
# (figures/comparison/generate_data.py:14-25)
SCENES = ["suzanne", "cranium", "bob", "bunny", "tshirt", "planck"]
STEP_SIZES = {"suzanne": 2e-3, "cranium": 5e-3, "bob": 3e-3, "bunny": 1e-2,
              "tshirt": 3e-3, "planck": 3e-3}
OURS_STEPS = {"suzanne": 1080, "cranium": 1820, "bob": 930, "bunny": 1380,
              "tshirt": 370, "planck": 915}
BASE_STEPS = {"suzanne": 1130, "cranium": 1910, "bob": 940, "bunny": 1450,
              "tshirt": 390, "planck": 960}
REGS_LAP = {"suzanne": 2.8, "cranium": 0.21, "bob": 0.67, "bunny": 3.8,
            "tshirt": 12.0, "planck": 3.8}
REGS_BILAP = {"suzanne": 3.8, "cranium": 0.16, "bob": 0.37, "bunny": 2.1,
              "tshirt": 12.0, "planck": 5.0}
COMMON = {"boost": 3, "loss": "l1", "alpha": 0.95}


def legs(scene, quick=False):
    """The three legs of ``scene``: [(name, driver params)]."""
    s_ours = 50 if quick else OURS_STEPS[scene]
    s_base = 50 if quick else BASE_STEPS[scene]
    return [
        (f"{scene}_ours",
         {**COMMON, "steps": s_ours, "smooth": True,
          "step_size": STEP_SIZES[scene], "optimizer": "AdamUniform"}),
        (f"{scene}_lapreg",
         {**COMMON, "steps": s_base, "smooth": False,
          "reg": REGS_LAP[scene], "bilaplacian": False,
          "optimizer": "Adam", "step_size": 1e-2}),
        (f"{scene}_bilapreg",
         {**COMMON, "steps": s_base, "smooth": False,
          "reg": REGS_BILAP[scene], "bilaplacian": True,
          "optimizer": "Adam", "step_size": 1e-2}),
    ]


def main(argv=None):
    args = cli(argv, __doc__.split("\n\n")[0])
    scenes = [args.only] if args.only else \
        (["suzanne"] if args.quick else SCENES)
    out = {}
    for scene in scenes:
        for name, params in legs(scene, args.quick):
            out[name] = run(name, scene, params, "comparison",
                            device=args.device)[1]
    return out


if __name__ == "__main__":
    main()
