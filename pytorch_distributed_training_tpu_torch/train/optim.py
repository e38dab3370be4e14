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
  The moments are stored in ``mu_dtype`` / ``nu_dtype`` (float32 or
  bfloat16, JAX's ``adam_mu_dtype`` / ``adam_nu_dtype``,
  ``train/fused_adamw.py``): each step upcasts them, runs the arithmetic
  above in float32 (the update from the float32 moments) and rounds them
  back. Gradients may come in bfloat16 (the accumulation carry,
  ``train/step.py``) and are upcast per tensor. Optional global-norm clipping first, as optax's
  ``clip_by_global_norm`` (off by default, as in the reference); the norm
  is ``grad_norm``'s, which for a model split or sharded over ranks
  (``sharded_grad_norm``: the branches or tensor parallelism's slices
  over ``model``, the layers over ``stage``, the FSDP shards) is the whole
  model's, replicated gradients counted once.

Under FSDP (``parallel/sharding.py``) a parameter and its gradient are
``DTensor``s sharded over the mesh's ``fsdp`` axis, beside plain tensors
(the replicated parameters). The norm and the update run on each
``DTensor``'s local shard (``to_local()``, a view of it: the update
writes the shard in place) and the plain tensors alike, so every
``_foreach_*`` list holds plain tensors only; the moments of a sharded
parameter are plain tensors of its shard's shape; the clip factor is a
0-dim tensor. A shard's squares are summed over ``fsdp``.

A plain PyTorch optimizer over ``torch._foreach_*`` ops: the update is no
Pallas kernel in the JAX package, so it has no CUDA kernel here.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from pytorch_distributed_training_tpu_torch.comms.collectives import (
    all_reduce_sum,
)


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype named ``name`` ("float32", "bfloat16", ...); a
    ``TypeError`` for a name that is no dtype, as ``jnp.dtype`` raises."""
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise TypeError(f"data type {name!r} not understood")
    return dt


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


def is_sharded(t) -> bool:
    """Whether ``t`` is a ``DTensor`` (an FSDP-sharded parameter or its
    gradient)."""
    return isinstance(t, DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a ``DTensor`` (a view), else ``t``."""
    return t.to_local() if isinstance(t, DTensor) else t


def _squares(tensors, zero) -> torch.Tensor:
    return sum((torch.sum(torch.square(local(t).float())) for t in tensors),
               zero)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32, of
    tensors held whole by this rank (a ``DTensor``: of its shard)."""
    return torch.sqrt(_squares(tensors, 0))


def plain_grad_norm(params, grads) -> torch.Tensor:
    """The global norm of ``grads`` (the gradients of ``params``), all
    held whole by this rank."""
    return global_norm(grads)


def sharded_grad_norm(split=frozenset(), group=None,
                      fsdp_group=None) -> Callable:
    """A grad-norm function for a model of which the parameters in
    ``split`` (a set of ``id``s) are this rank's part of a model split
    over ``group`` (each rank of it holds others), the rest replicated on
    every rank of it, and whose ``DTensor`` gradients are this rank's
    shards over ``fsdp_group``: the squares of the replicated gradients
    counted once, a shard's summed over ``fsdp_group``, then the split
    ones' over ``group``."""

    def norm(params, grads) -> torch.Tensor:
        zero = local(grads[0]).new_zeros((), dtype=torch.float32)

        def part(in_split, sharded):
            return _squares([g for p, g in zip(params, grads)
                             if (id(p) in split) == in_split
                             and is_sharded(g) == sharded], zero)

        shards = all_reduce_sum(torch.stack([part(False, True),
                                             part(True, True)]), fsdp_group)
        return torch.sqrt(part(False, False) + shards[0] + all_reduce_sum(
            part(True, False) + shards[1], group))

    return norm


class AdamW(torch.optim.Optimizer):
    """optax-ordered AdamW with a schedule (see the module docstring).

    ``step()`` applies update number ``self.count`` with learning rate
    ``schedule(self.count)`` to every parameter that has a gradient.
    """

    def __init__(self, params, schedule: Callable[[int], float], *,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, max_grad_norm: float = 0.0,
                 grad_norm: Callable = plain_grad_norm,
                 mu_dtype: str = "float32", nu_dtype: str = "float32"):
        super().__init__(params, dict(b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay))
        self.schedule = schedule
        self.max_grad_norm = max_grad_norm
        self.grad_norm = grad_norm
        self.mu_dtype = torch_dtype(mu_dtype)
        self.nu_dtype = torch_dtype(nu_dtype)
        self.count = 0

    def moments(self, p) -> tuple[torch.Tensor, torch.Tensor]:
        """(mu, nu) of parameter ``p``, made (zeros of its local shape in
        the moment dtypes) on first use."""
        st = self.state[p]
        if not st:
            w = local(p)
            st["mu"] = torch.zeros_like(w, dtype=self.mu_dtype)
            st["nu"] = torch.zeros_like(w, dtype=self.nu_dtype)
        return st["mu"], st["nu"]

    @torch.no_grad()
    def step(self, closure=None, grads: Optional[dict] = None):
        """One update from each parameter's ``.grad``, or from ``grads``
        (parameter -> gradient, e.g. a bfloat16 accumulation carry, which
        ``.grad`` cannot hold). The parameters update in chunks of at most
        ``CHUNK`` elements, so the update's float32 temporaries (and the
        working copies of narrow moments) exist a chunk at a time."""
        if closure is not None:
            raise ValueError("AdamW.step takes no closure")
        lr = self.schedule(self.count)
        self.count += 1
        for group in self.param_groups:
            gs = {p: p.grad if grads is None else grads.get(p)
                  for p in group["params"]}
            held = [p for p in group["params"] if gs[p] is not None]
            if not held:
                continue
            clip = None
            if self.max_grad_norm > 0:
                norm = self.grad_norm(held, [gs[p] for p in held])
                clip = (norm >= self.max_grad_norm, norm)
            for part in _chunks(held, CHUNK):
                self._update(group, part, [gs[p] for p in part], lr, clip)

    def _update(self, group, held, grads, lr, clip) -> None:
        # each shard and each whole tensor: plain tensors only
        params = [local(p) for p in held]
        grads = [local(g).float() for g in grads]
        if clip is not None:
            over, norm = clip
            grads = [torch.where(over, g / norm * self.max_grad_norm, g)
                     for g in grads]
        b1, b2, eps = group["b1"], group["b2"], group["eps"]
        stored_mu, stored_nu = zip(*(self.moments(p) for p in held))
        # float32 working copies of moments stored narrower
        mus = [m.float() for m in stored_mu]
        nus = [n.float() for n in stored_nu]
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
        for stored, work in ((stored_mu, mus), (stored_nu, nus)):
            if stored[0].dtype != torch.float32:
                torch._foreach_copy_(list(stored), work)
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


#: elements a chunk of the update holds (float32 temporaries of 256 MiB a
#: tensor list); a larger tensor is a chunk of its own
CHUNK = 1 << 26


def _chunks(params, limit: int):
    """``params`` in order, in runs of at most ``limit`` elements."""
    out, run, n = [], [], 0
    for p in params:
        if run and n + p.numel() > limit:
            out.append(run)
            run, n = [], 0
        run.append(p)
        n += p.numel()
    return out + [run] if run else out
