"""Thread-correctness layer: the runtime lock registry (counterpart: the
JAX package's ``analysis/concurrency/``)::

    from pytorch_distributed_training_tpu_torch.analysis import concurrency

    self._lock = concurrency.lock("serve.queue")   # drop-in Lock

The mode rides ``PDT_TPU_GUARDS``: ``off`` — plain stdlib locks, zero
overhead; ``record`` (default) — contention/hold/wait accounting and
``lock_order_violation`` records; ``strict`` — order inversions raise
``LockOrderViolation`` before the lock is taken. See ``locks.py``.
``guard_mode_from_env`` is ``analysis/guards.py``'s, re-exported here on
first use (``guards`` imports this package).
"""

from pytorch_distributed_training_tpu_torch.analysis.concurrency.locks import (
    LockOrderViolation,
    LockRegistry,
    TracedLock,
    get_lock_registry,
    held_lock_names,
    lock,
    rlock,
    set_lock_registry,
    start_periodic_summary,
)

__all__ = [
    "LockOrderViolation",
    "LockRegistry",
    "TracedLock",
    "get_lock_registry",
    "guard_mode_from_env",
    "held_lock_names",
    "lock",
    "rlock",
    "set_lock_registry",
    "start_periodic_summary",
]


def __getattr__(name: str):
    if name == "guard_mode_from_env":
        from pytorch_distributed_training_tpu_torch.analysis.guards import (
            guard_mode_from_env,
        )

        return guard_mode_from_env
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
