"""The regularization-failure experiment on the port: suzanne from its
silhouette alone, ours against Adam with bilaplacian regularization at
three weights (``figures/reg_fail/generate_data.py``; reference
figures/reg_fail/generate_data.py:19-38).

    python -m largesteps_torch.figures.reg_fail [--quick] [--only reg_400]
        [--device cuda]

Shading and the translation channel off, l2 loss, boost 3, 25,001 steps at
5e-3: ``ours`` AdamUniform at λ = 99, ``reg_{w:g}`` Adam on the coordinates
at bilaplacian weights 1, 400 and 10,000.  ``--quick`` runs ``ours`` and
``reg_400``, 60 steps each.
"""
from __future__ import annotations

from .common import cli, run

__all__ = ["WEIGHTS", "STEPS", "COMMON", "QUICK_WEIGHTS", "QUICK_STEPS",
           "legs", "main"]

WEIGHTS = [1.0, 400.0, 10000.0]
STEPS = 25001
COMMON = {"shading": False, "boost": 3, "loss": "l2", "use_tr": False}
QUICK_WEIGHTS = [400.0]
QUICK_STEPS = 60


def legs(quick=False):
    """[(leg name, scene, driver params)]."""
    steps = QUICK_STEPS if quick else STEPS
    return [("ours", "suzanne",
             {**COMMON, "steps": steps, "smooth": True, "lambda": 99.0,
              "step_size": 5e-3, "optimizer": "AdamUniform"})] + [
        (f"reg_{w:g}", "suzanne",
         {**COMMON, "steps": steps, "smooth": False, "reg": w,
          "optimizer": "Adam", "step_size": 5e-3, "bilaplacian": True})
        for w in (QUICK_WEIGHTS if quick else WEIGHTS)]


def main(argv=None):
    args = cli(argv, __doc__.split("\n\n")[0])
    return {name: run(name, scene, params, "reg_fail",
                      device=args.device)[1]
            for name, scene, params in legs(args.quick)
            if not args.only or name == args.only}


if __name__ == "__main__":
    main()
