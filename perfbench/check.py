"""The comparison that decides ``correct``.

A cell's timed call of ``optimize_shape`` hands over, through the
benchmark's optimizer wrapper (``run.Probe``), what its own steps made:
the parameters at the first and second steps, the first step's gradients
as the optimizer got them, the last step's parameters and gradients, and
the driver's logged image losses.  The reference (``reference.py``)
renders the first step from the seed's scene and evaluates the last step
at the program's own parameters there (it cannot follow hundreds of
steps: that step stands for every rebin and bin the window made).  Five
numbers, each with a limit of the cell's (``workloads/<cell>.json``,
``limits``):

* ``loss_first``: the relative gap of the first step's image loss;
* ``grad_first``: the first step's gradient with respect to the solved
  vertices, ∂L/∂v = M ∂L/∂u worked out from the gradient the optimizer
  got by the reference's M in float64 (on a coordinate leg, whose
  parameters are the vertices, that gradient itself), the typical vertex's
  gap
  (:func:`reference.row_gap`: the median over vertices of ‖g − g_ref‖
  over the median of ‖g_ref‖);
* ``update_first``: the first update's worst leaf (|‖Δ‖ − ‖Δ_ref‖ over
  the larger of ‖Δ_ref‖ of that leaf and of the median leaf) against the
  reference optimizer's update from the program's own first gradients:
  the optimizer stage on the program's state;
* ``loss_last``: the relative gap of the last step's image loss;
* ``grad_last``: the last step's, as ``grad_first``.

Why these and not three steps followed from the seed, or the norms of
the gradients the optimizer gets: the program solves in float32 (the
configuration's precision; some 1e-5 of a vertex against the reference's
float64), and where two faces lie at one depth to rounding each side
breaks the tie its own way, which moves a boosted antialias gradient to
other vertices.  The adjoint solve spreads each such entry over a few
rings of ∂L/∂u, the translation's gradient sums all of them, and
AdamUniform divides every entry by the largest second moment of its
leaf, so followed trajectories, norms and u-space gradients swing from
seed to seed with a few entries; in v-space the typical vertex does not.
:func:`record` reads the swinging numbers for the record
(``calibrate.py``).

The same numbers are read of the control (the reference in TF32 in the
program's place) and of planted faults by :func:`side_outputs`.
"""
from __future__ import annotations

import math
import statistics

import torch

from .reference import Optimizer, Reference, leaf_gap, row_gap

__all__ = ["NUMBERS", "numbers", "record", "judge", "side_outputs"]

NUMBERS = ("loss_first", "grad_first", "update_first", "loss_last",
           "grad_last")
FOLLOW = 3


def side_outputs(side: Reference, theta_last, follow=1) -> dict:
    """What a side in the program's place gives: its own first ``follow``
    steps from the scene, and the last step's loss and gradients at the
    program's parameters ``theta_last``."""
    losses, first, start, after = side.follow(
        follow, freeze=side.fault == "freeze", keep=1)
    im, gu, gt = side.grads(theta_last["u"], theta_last["tr"])
    return {"losses": losses, "grad0": first, "theta0": start,
            "theta1": after[1], "theta3": after[follow],
            "loss_last": im, "grad_last": {"tr": gt, "u": gu}}


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def numbers(out: dict, r: dict, ref: Reference) -> dict:
    """The five numbers of ``out`` (a side's outputs) against ``r``, the
    reference's (:func:`side_outputs`); ``ref`` gives the optimizer and
    M."""
    opt = Optimizer(ref.p.get("optimizer", "AdamUniform"),
                    float(ref.p["step_size"]))
    want = opt.step(out["theta0"], out["grad0"])
    if ref.smooth:                               # ∂L/∂v = M ∂L/∂u
        gv = lambda g: ref.M.mv(g["u"].double())
    else:                                        # u is v
        gv = lambda g: g["u"]
    res = {"loss_first": _rel(out["losses"][0], r["losses"][0]),
           "grad_first": row_gap(gv(out["grad0"]), gv(r["grad0"])),
           "update_first": leaf_gap(
               {k: out["theta1"][k] - out["theta0"][k] for k in want},
               {k: want[k] - out["theta0"][k] for k in want}),
           "loss_last": _rel(out["loss_last"], r["loss_last"]),
           "grad_last": row_gap(gv(out["grad_last"]), gv(r["grad_last"]))}
    return {k: (v if math.isfinite(v) else math.inf) for k, v in res.items()}


def record(out: dict, r: dict) -> dict:
    """For the record, not judged: the gradients' worst-leaf norm gaps,
    the largest relative gap of the first three image losses and the
    parameters' change over three steps (leaves whose reference gradient
    is under a thousandth of the median leaf's left out), each side
    following its own trajectory (``r`` followed three steps)."""
    norms = {k: float(torch.linalg.vector_norm(g.double()))
             for k, g in r["grad0"].items()}
    med = statistics.median(norms.values())
    quiet = tuple(k for k, n in norms.items() if n < 1e-3 * med)
    d = lambda o: {k: o["theta3"][k] - o["theta0"][k] for k in o["theta0"]}
    return {"grad_first_norm": leaf_gap(out["grad0"], r["grad0"]),
            "grad_last_norm": leaf_gap(out["grad_last"], r["grad_last"]),
            "loss_first3": max(_rel(a, b) for a, b in
                               zip(out["losses"][:FOLLOW], r["losses"])),
            "change_3": leaf_gap(d(out), d(r), skip=quiet)}


def judge(nums: dict, limits: dict) -> bool:
    """Correct when every number is finite and each within its limit (a
    null limit: read, not compared)."""
    return all(k in nums and math.isfinite(nums[k])
               and (limits[k] is None or nums[k] <= limits[k])
               for k in NUMBERS)
