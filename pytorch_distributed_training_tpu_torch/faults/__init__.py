"""Fault tolerance (counterpart: the JAX package's ``faults/``):

- ``inject``: deterministic fault injection (``PDT_TPU_FAULT``): a crash,
  a SIGTERM or a hang after a chosen step, a corrupted checkpoint, a slow
  host, so every recovery path runs end to end in CPU tests;
- ``preemption``: SIGTERM/SIGINT stop the run at the next step boundary
  with an emergency checkpoint and exit 75, which a supervisor restarts
  without counting a failure;
- ``watchdog``: a monitor thread around blocking sections (the step, the
  checkpoint saves) that records a ``watchdog_stall`` with every thread's
  stack after a multiple of the section's median time, and exits 84 past
  a hard timeout, so a hung job restarts instead of waiting forever.

Restarts are ``utils/supervisor.run_with_restarts``.
"""
