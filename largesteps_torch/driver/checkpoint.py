"""Checkpoint and resume in the JAX package's ``.npz`` format.

Port of ``largesteps_tpu/driver/checkpoint.py`` (lines 35-71).  A file holds
theta, the optimizer state, the epoch's source mesh and a JSON ``meta``
record (step, step size, remesh schedule).  The leaves are stored in the
order ``jax.tree_util.tree_leaves`` gives the JAX package's pytrees, so a
run of either package resumes in the other:

* theta: ``leaf_0`` = tr (1, 3), ``leaf_1`` = u (V, 3);
* optimizer: ``leaf_0`` = count, ``leaf_1`` = g1.tr, ``leaf_2`` = g1.u,
  ``leaf_3`` = g2.tr, ``leaf_4`` = g2.u.
"""
from __future__ import annotations

import json

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint", "state_from_numpy",
           "state_to_numpy"]


def state_to_numpy(theta, optimizer):
    """(theta leaves, optimizer leaves) as numpy lists in the JAX order.
    ``theta`` is ``{"u", "tr"}``; the optimizer keeps (count, g1, g2) per
    parameter (an optimizer that has not stepped yet has zero moments)."""
    params = (theta["tr"], theta["u"])
    th = [p.detach().cpu().numpy() for p in params]
    states = [optimizer.state.get(p, {}) for p in params]
    count = states[0].get("count", 0)
    moments = []
    for key in ("g1", "g2"):
        for p, st in zip(params, states):
            m = st.get(key)
            moments.append(np.zeros(p.shape, np.float32) if m is None
                           else m.detach().cpu().numpy())
    return th, [np.asarray(count, np.int32)] + moments


def state_from_numpy(theta_leaves, opt_leaves, device):
    """Turn JAX-ordered leaves into the port's theta and optimizer state.

    Returns (theta ``{"u", "tr"}`` as leaf tensors on ``device``, a function
    that loads the moments into an optimizer built over
    ``[theta["tr"], theta["u"]]``)."""
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                     device=device)
    theta = {"tr": as_t(theta_leaves[0]).requires_grad_(True),
             "u": as_t(theta_leaves[1]).requires_grad_(True)}
    count = int(np.asarray(opt_leaves[0]))
    g1 = (as_t(opt_leaves[1]), as_t(opt_leaves[2]))
    g2 = (as_t(opt_leaves[3]), as_t(opt_leaves[4]))

    def load_into(optimizer):
        for i, p in enumerate((theta["tr"], theta["u"])):
            optimizer.state[p] = {"count": count, "g1": g1[i].clone(),
                                  "g2": g2[i].clone()}

    return theta, load_into


def save_checkpoint(path, *, theta, optimizer, v_src, f_src, step,
                    step_size, remesh_schedule=(), extras=None):
    """Write one self-contained resume point."""
    th, op = state_to_numpy(theta, optimizer)
    payload = {f"theta_leaf_{i}": a for i, a in enumerate(th)}
    payload.update({f"opt_leaf_{i}": a for i, a in enumerate(op)})
    payload["v_src"] = np.asarray(v_src)
    payload["f_src"] = np.asarray(f_src)
    meta = {
        "step": int(step),
        "step_size": float(step_size),
        "remesh_schedule": [int(x) for x in remesh_schedule],
        "extras": extras or {},
    }
    payload["meta_json"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(path, **payload)


def load_checkpoint(path):
    """Read a checkpoint: {"v_src", "f_src", "meta", "theta", "opt_state"},
    the last two as JAX-ordered lists of numpy leaves."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["meta_json"]).decode())

        def leaves(prefix):
            n = sum(1 for k in data.files if k.startswith(prefix))
            return [data[f"{prefix}{i}"] for i in range(n)]

        return {"v_src": data["v_src"], "f_src": data["f_src"],
                "meta": meta, "theta": leaves("theta_leaf_"),
                "opt_state": leaves("opt_leaf_")}
