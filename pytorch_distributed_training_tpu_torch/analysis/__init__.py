"""Correctness tooling (counterpart: the JAX package's ``analysis/``).

Ported so far: ``concurrency/``, the runtime lock registry — named
``lock()``/``rlock()`` factories that record contention, hold and wait
per lock and catch lock-order inversions live. The runtime guards, the
SPMD audit and the static rules are still to come (ROADMAP.md, queue 1,
item 7b). Nothing here imports torch: the fleet's coordinator process
locks too.
"""
