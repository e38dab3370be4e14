"""Optimizer and learning-rate schedule of the reference recipe
(counterpart: the JAX package's ``train/optim.py`` and
``train/fused_adamw.py``).

- ``linear_warmup_schedule``: 0 -> peak over the warmup steps, then linear
  decay to 0 at ``total_steps`` (transformers'
  ``get_linear_schedule_with_warmup``). Update k (counted from 0, as optax
  counts) uses ``schedule(k)``, so the first update's learning rate is 0.
  The values are computed in float32 with optax's formula.
- ``AdamW``: bias-corrected Adam with decoupled weight decay, in optax's
  order and grouping: ``mu = b1*mu + (1-b1)*g``, ``nu = b2*nu +
  (1-b2)*(g*g)``, ``upd = (mu/b1c) / (sqrt(nu/b2c) + eps)``, then ``upd +=
  weight_decay * p`` before the learning-rate scale, ``p += -lr * upd``.
  Moments are float32. Optional global-norm clipping first, as optax's
  ``clip_by_global_norm`` (off by default, as in the reference); the norm
  is ``grad_norm``'s, which for a model split over ranks
  (``sharded_grad_norm``) is the whole model's.

A plain PyTorch optimizer over ``torch._foreach_*`` ops: the update is no
Pallas kernel in the JAX package, so it has no CUDA kernel here.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from pytorch_distributed_training_tpu_torch.comms.collectives import (
    all_reduce_sum,
)


def _linear(init: float, end: float, steps: int, count: int) -> np.float32:
    """optax ``linear_schedule(init, end, steps)(count)`` in float32."""
    c = np.float32(min(max(count, 0), steps))
    frac = np.float32(1.0) - c / np.float32(steps)
    return np.float32(init - end) * frac + np.float32(end)


def linear_warmup_schedule(peak_lr: float, warmup_steps: int,
                           total_steps: int) -> Callable[[int], float]:
    """0 -> peak over ``warmup_steps``, then linear decay -> 0 at
    ``total_steps``."""
    warmup = max(warmup_steps, 1)
    decay = max(total_steps - warmup, 1)

    def schedule(count: int) -> float:
        if count < warmup:
            return float(_linear(0.0, peak_lr, warmup, count))
        return float(_linear(peak_lr, 0.0, decay, count - warmup))

    return schedule


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors))


def plain_grad_norm(params, grads) -> torch.Tensor:
    """The global norm of ``grads`` (the gradients of ``params``), all
    held whole by this rank."""
    return global_norm(grads)


def sharded_grad_norm(sharded, group) -> Callable:
    """A grad-norm function for a model of which the parameters in
    ``sharded`` (a set of ``id``s) are this rank's part of a model split
    over ``group`` (each rank of it holds others), and the rest are
    replicated on every rank of it: the squares of the replicated
    gradients counted once, those of the split ones summed over the
    group."""

    def norm(params, grads) -> torch.Tensor:
        zero = grads[0].new_zeros((), dtype=torch.float32)
        own = sum((torch.sum(torch.square(g.float()))
                   for p, g in zip(params, grads) if id(p) in sharded), zero)
        rep = sum((torch.sum(torch.square(g.float()))
                   for p, g in zip(params, grads) if id(p) not in sharded),
                  zero)
        return torch.sqrt(rep + all_reduce_sum(own, group))

    return norm


class AdamW(torch.optim.Optimizer):
    """optax-ordered AdamW with a schedule (see the module docstring).

    ``step()`` applies update number ``self.count`` with learning rate
    ``schedule(self.count)`` to every parameter that has a gradient.
    """

    def __init__(self, params, schedule: Callable[[int], float], *,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, max_grad_norm: float = 0.0,
                 grad_norm: Callable = plain_grad_norm):
        super().__init__(params, dict(b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay))
        self.schedule = schedule
        self.max_grad_norm = max_grad_norm
        self.grad_norm = grad_norm
        self.count = 0

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamW.step takes no closure")
        lr = self.schedule(self.count)
        self.count += 1
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad.float() for p in params]
            if self.max_grad_norm > 0:
                norm = self.grad_norm(params, grads)
                clip = norm >= self.max_grad_norm
                grads = [torch.where(clip, g / norm * self.max_grad_norm, g)
                         for g in grads]
            b1, b2, eps = group["b1"], group["b2"], group["eps"]
            mus, nus = [], []
            for p in params:
                st = self.state[p]
                if not st:
                    st["mu"] = torch.zeros_like(p, dtype=torch.float32)
                    st["nu"] = torch.zeros_like(p, dtype=torch.float32)
                mus.append(st["mu"])
                nus.append(st["nu"])
            # float32 integer-exponent powers, as optax's bias correction
            b1c = float(np.float32(1.0) - np.float32(b1) ** self.count)
            b2c = float(np.float32(1.0) - np.float32(b2) ** self.count)
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, torch._foreach_mul(grads, 1 - b1))
            g2 = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(g2, 1 - b2)
            torch._foreach_mul_(nus, b2)
            torch._foreach_add_(nus, g2)
            del g2
            denom = torch._foreach_div(nus, b2c)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, eps)
            upd = torch._foreach_div(mus, b1c)
            torch._foreach_div_(upd, denom)
            del denom
            if group["weight_decay"]:
                torch._foreach_add_(
                    upd, torch._foreach_mul(params, group["weight_decay"])
                )
            torch._foreach_mul_(upd, -lr)
            torch._foreach_add_(params, upd)
