"""Correctness tooling (counterpart: the JAX package's ``analysis/``):

- **Static linter** (``lint.py`` + ``rules/``): an AST pass over the
  package with the thread-safety rules, ``mutable-default`` and
  ``host-sync-in-loop`` (torch's syncs in the train/ and serve/ host
  loops). ``cli/lint.py`` drives it; every finding is fixed or waived in
  ``waivers.toml`` with a reason, so ``cli/lint.py --check`` gates a
  clean tree.
- **Runtime guards** (``guards.py``): the recompile detector around the
  trainer's steps and the serve engine's device calls, the
  implicit-transfer detector (torch's sync debug mode, routed by thread)
  armed around warm calls and the serve tick, and the sharding audit.
- **Collective audit** (``spmd/``): the collectives a window issued,
  checked against an expected-collective manifest.
- **Runtime lock registry** (``concurrency/``): instrumented
  ``lock()``/``rlock()`` factories recording contention, hold and wait
  per lock and catching lock-order inversions live.

Nothing here imports torch at import time: the fleet's coordinator
process locks too (``concurrency``), and ``guards`` imports torch inside
the functions that touch a tensor or the card.
"""
