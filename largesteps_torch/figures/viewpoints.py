"""The viewpoint-count experiment on the port: the bunny scene seen from 1
to 49 cameras, ours against Adam with bilaplacian regularization at the
reference's equal-time step counts (``figures/viewpoints/generate_data.py``;
reference figures/viewpoints/generate_data.py:15-45).

    python -m largesteps_torch.figures.viewpoints [--quick] [--only views_4_ours]
        [--device cuda]

Boost 3, step size 1e-2, l1 loss, α = 0.95; ``views_{n}_ours`` is
AdamUniform on the solved parameterization, ``views_{n}_reg`` Adam on the
coordinates with bilaplacian weight 2.1.  ``--quick`` runs the 4-camera
pair, 60 steps a leg.
"""
from __future__ import annotations

from .common import SCENES, cli, run

__all__ = ["CAMS", "STEPS_OURS", "STEPS_REG", "COMMON", "QUICK",
           "QUICK_STEPS", "legs", "main"]

CAMS = [1, 2, 4, 9, 16, 25, 49]
STEPS_OURS = [5240, 4470, 3350, 2030, 1370, 930, 510]
STEPS_REG = [6620, 5580, 3900, 2220, 1440, 960, 510]
COMMON = {"boost": 3, "step_size": 1e-2, "loss": "l1", "alpha": 0.95}
QUICK = 2                # the index of CAMS that --quick runs
QUICK_STEPS = 60


def legs(quick=False):
    """[(leg name, scene (make_scene arguments), driver params)]: the
    bunny scene with n views, ``dict(SCENES["bunny"], n_views=n)``, built
    a leg at a time (SCENES itself is left as it is)."""
    out = []
    for i in ([QUICK] if quick else range(len(CAMS))):
        n = CAMS[i]
        scene = dict(SCENES["bunny"], n_views=n)
        out += [
            (f"views_{n}_ours", scene,
             {**COMMON, "steps": QUICK_STEPS if quick else STEPS_OURS[i],
              "smooth": True, "optimizer": "AdamUniform"}),
            (f"views_{n}_reg", scene,
             {**COMMON, "steps": QUICK_STEPS if quick else STEPS_REG[i],
              "smooth": False, "reg": 2.1, "bilaplacian": True,
              "optimizer": "Adam"}),
        ]
    return out


def main(argv=None):
    args = cli(argv, __doc__.split("\n\n")[0])
    return {name: run(name, scene, params, "viewpoints",
                      device=args.device)[1]
            for name, scene, params in legs(args.quick)
            if not args.only or name == args.only}


if __name__ == "__main__":
    main()
