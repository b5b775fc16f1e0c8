"""AdamUniform and plain Adam as ``torch.optim.Optimizer``s.

Port of ``largesteps_tpu/core/optimize.py``: ``adam_uniform`` and ``adam``
(``optax.adam``).  Both keep the state of the JAX transformations, ``(count,
g1, g2)``: biased first and second moments and one step count, so the
checkpoints of either optimizer hold the same leaves.  AdamUniform divides
each parameter's update by the largest component of its bias-corrected
√m̂2 (lines 53-71) instead of elementwise, which keeps the preconditioned
gradient direction smooth; Adam divides elementwise, as the baselines of
the comparison figure run it.
"""
from __future__ import annotations

import torch

__all__ = ["AdamUniform", "Adam"]


class _Moments(torch.optim.Optimizer):
    """Adam's moments and bias corrections; subclasses give the update
    from the bias-corrected moments.  Per parameter: ``state[p] = {"count",
    "g1", "g2"}``; every parameter's count is the same (the JAX state has a
    single scalar)."""

    def __init__(self, params, lr, betas=(0.9, 0.999), eps=1e-8):
        super().__init__(params, dict(lr=float(lr), betas=betas,
                                      eps=float(eps)))

    @staticmethod
    def _update(m1_hat, m2_hat, lr, eps):
        raise NotImplementedError

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
                p.add_(self._update(st["g1"] / c1, st["g2"] / c2,
                                    group["lr"], group["eps"]))
        return loss


class AdamUniform(_Moments):
    """Adam whose denominator is ``eps + sqrt(max(m̂2))`` per parameter
    (reference largesteps/optimize.py:39-41)."""

    @staticmethod
    def _update(m1_hat, m2_hat, lr, eps):
        return -lr * m1_hat / (eps + torch.sqrt(torch.max(m2_hat)))


class Adam(_Moments):
    """Plain Adam, ``optax.adam``: ``-lr · m̂1 / (sqrt(m̂2) + eps)``
    elementwise (the reference's baselines pass ``torch.optim.Adam``,
    scripts/main.py:41)."""

    @staticmethod
    def _update(m1_hat, m2_hat, lr, eps):
        return m1_hat / (torch.sqrt(m2_hat) + eps) * -lr
