"""AdamUniform as a ``torch.optim.Optimizer``.

Port of ``largesteps_tpu/core/optimize.py:adam_uniform``.  It keeps the
state of the JAX transformation, ``(count, g1, g2)``: biased first and
second moments and one step count.  It divides each parameter's update by
the largest component of its bias-corrected √m̂2 (lines 53-71) instead of
elementwise, which keeps the preconditioned gradient direction smooth.
Plain ``adam`` is still to port (ROADMAP.md Queue 1, item 1).
"""
from __future__ import annotations

import torch

__all__ = ["AdamUniform"]


class AdamUniform(torch.optim.Optimizer):
    """Adam whose denominator is ``eps + sqrt(max(m̂2))`` per parameter
    (reference largesteps/optimize.py:39-41).  Per parameter:
    ``state[p] = {"count", "g1", "g2"}``; every parameter's count is the
    same (the JAX state has a single scalar)."""

    def __init__(self, params, lr, betas=(0.9, 0.999), eps=1e-8):
        super().__init__(params, dict(lr=float(lr), betas=betas,
                                      eps=float(eps)))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                st = self.state[p]
                if not st:
                    st["count"] = 0
                    st["g1"] = torch.zeros_like(p)
                    st["g2"] = torch.zeros_like(p)
                st["count"] += 1
                st["g1"].mul_(b1).add_((1 - b1) * g)
                st["g2"].mul_(b2).add_((1 - b2) * g * g)
                # bias corrections in float32, as the JAX state computes
                # them; filled on the device, since copying a host tensor
                # there would wait for the device to drain
                n = torch.tensor(float(st["count"]), dtype=torch.float32)
                c1, c2 = (torch.full((), float(1.0 - torch.tensor(
                    b, dtype=torch.float32) ** n), dtype=torch.float32,
                    device=p.device) for b in (b1, b2))
                m1_hat = st["g1"] / c1
                m2_hat = st["g2"] / c2
                p.add_(-group["lr"] * m1_hat
                       / (group["eps"] + torch.sqrt(torch.max(m2_hat))))
        return loss
