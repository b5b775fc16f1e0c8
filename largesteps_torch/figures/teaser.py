"""The teaser experiment on the port: the nefertiti scene, four methods at
the reference's equal-time step counts (``figures/teaser/generate_data.py``;
reference figures/teaser/generate_data.py:18-38).

    python -m largesteps_torch.figures.teaser [--quick] [--only ours]
        [--device cuda]

Boost 3, α = 0.98, l1 loss; AdamUniform at 2e-3 for the smooth legs, Adam
at 1e-2 for ``reg`` (weight 16) and ``naive``.  ``ours_remesh`` starts from
``nefertiti_coarse`` and remeshes at step 250: the port's driver raises
``NotImplementedError`` on it until remeshing is ported (ROADMAP.md Queue
1).  ``cull_backfaces`` stays off, as in the JAX experiment.  ``--quick``
runs at most 50 steps a leg.
"""
from __future__ import annotations

from .common import cli, run

__all__ = ["SCENE", "COMMON", "METHODS", "main"]

SCENE = "nefertiti"
COMMON = {"boost": 3, "alpha": 0.98, "loss": "l1"}
METHODS = {
    "ours":        {**COMMON, "steps": 2170, "smooth": True,
                    "step_size": 2e-3, "optimizer": "AdamUniform"},
    "ours_remesh": {**COMMON, "steps": 1320, "smooth": True,
                    "step_size": 2e-3, "optimizer": "AdamUniform",
                    "remesh": 250},
    "reg":         {**COMMON, "steps": 2500, "smooth": False, "reg": 16.0,
                    "step_size": 1e-2, "optimizer": "Adam"},
    "naive":       {**COMMON, "steps": 2420, "smooth": False,
                    "step_size": 1e-2, "optimizer": "Adam"},
}


def main(argv=None):
    args = cli(argv, __doc__.split("\n\n")[0])
    out = {}
    for name, params in METHODS.items():
        if args.only and name != args.only:
            continue
        if args.quick:
            params = dict(params, steps=min(params["steps"], 50))
        scene = "nefertiti_coarse" if name == "ours_remesh" else SCENE
        out[name] = run(name, scene, params, "teaser",
                        device=args.device)[1]
    return out


if __name__ == "__main__":
    main()
