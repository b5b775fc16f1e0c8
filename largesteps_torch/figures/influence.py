"""The α-influence experiment on the port: suzanne fitted with the α form
``M = (1 − α) I + α L`` of the parameterization at eight values of α
(``figures/influence/generate_data.py``; reference
figures/influence/generate_data.py:19-34).

    python -m largesteps_torch.figures.influence [--quick] [--only alpha_0.95]
        [--device cuda]

4,300 steps of AdamUniform at 1e-3, l1 loss, boost 3, ``lambda`` None;
legs ``alpha_{α:g}``.  ``--quick`` runs α = 0.95, 50 steps.
"""
from __future__ import annotations

from .common import cli, run

__all__ = ["ALPHAS", "STEPS", "QUICK_ALPHAS", "QUICK_STEPS", "legs", "main"]

ALPHAS = [0.0, 0.25, 0.5, 0.75, 0.95, 0.98, 0.99, 0.999]
STEPS = 4300
QUICK_ALPHAS = [0.95]
QUICK_STEPS = 50


def legs(quick=False):
    """[(leg name, scene, driver params)]."""
    return [(f"alpha_{a:g}", "suzanne",
             {"steps": QUICK_STEPS if quick else STEPS, "smooth": True,
              "alpha": a, "lambda": None, "step_size": 1e-3, "loss": "l1",
              "boost": 3, "optimizer": "AdamUniform"})
            for a in (QUICK_ALPHAS if quick else ALPHAS)]


def main(argv=None):
    args = cli(argv, __doc__.split("\n\n")[0])
    return {name: run(name, scene, params, "influence",
                      device=args.device)[1]
            for name, scene, params in legs(args.quick)
            if not args.only or name == args.only}


if __name__ == "__main__":
    main()
