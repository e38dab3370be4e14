"""Rule registry: every lint rule module, in reporting order (counterpart:
the JAX package's ``analysis/rules/__init__.py``).

A rule module exposes ``RULE_ID`` (or ``RULE_IDS`` when it reports more
than one) and ``check(ctx: ModuleContext) -> list[Finding]``. Adding a
rule = adding a module here; the driver (``analysis/lint.py``) and
``cli/lint.py`` pick it up automatically.

The port keeps JAX's framework-agnostic rules: ``mutable-default``, the
concurrency rules (thread_shared, lock_discipline, thread_lifecycle),
which lint the hand-rolled threaded surface — serve loop, router, fleet,
hotswap watcher, prefetch, telemetry sink — against the race/deadlock/
shutdown-hang classes documented in each module, and
``host-sync-in-loop`` over torch's syncs. JAX's traced-scope rules
(``traced-branch``, ``impure-call``, ``host-transfer-traced``,
``missing-donation``, ``prng-reuse``) and its spmd rules lint jit,
PRNG-key, donation and ``PartitionSpec`` code the eager port does not
have.
"""

from pytorch_distributed_training_tpu_torch.analysis.rules import (
    host_transfer,
    lock_discipline,
    mutable_default,
    thread_lifecycle,
    thread_shared,
)
from pytorch_distributed_training_tpu_torch.analysis.rules.common import (
    Finding,
    ModuleContext,
)

ALL_RULES = (
    host_transfer,
    mutable_default,
    thread_shared,
    lock_discipline,
    thread_lifecycle,
)


def _ids(mod) -> tuple:
    ids = getattr(mod, "RULE_IDS", None)
    if ids is not None:
        return tuple(ids)
    return (mod.RULE_ID,)


RULE_IDS = tuple(rid for mod in ALL_RULES for rid in _ids(mod))

__all__ = ["ALL_RULES", "RULE_IDS", "Finding", "ModuleContext"]
