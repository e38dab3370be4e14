"""Restart from a checkpoint after a failure (counterpart: the JAX
package's ``utils/supervisor.py``).

``run_with_restarts`` calls a training attempt until it returns: a failed
attempt is retried (``TrainConfig.resume``: from the newest verified
checkpoint, mid-epoch included) while the restart budget allows, after a
decorrelated-jitter backoff, so ranks that died together do not come back
in lockstep. The budget is lifetime (``max_restarts`` in all) or sliding
(``max_restarts`` within ``restart_window_s``). A preemption
(``faults.preemption.Preempted``, exit 75) is not a failure: it passes
through at once without spending a restart, since the host is going away.

A retry runs in the same process: the process group stays joined (the
Trainer's ``comms/bootstrap.initialize`` joins nothing new, and the CLIs
leave the group only after the last attempt), the kernels' libraries stay
loaded, and the CUDA context stays, so only the Trainer is made anew.
"""

from __future__ import annotations

import random
import time
from collections import deque
from typing import Callable, TypeVar

from pytorch_distributed_training_tpu_torch.faults.preemption import Preempted
from pytorch_distributed_training_tpu_torch.telemetry.registry import (
    get_registry,
)
from pytorch_distributed_training_tpu_torch.utils.logging import log0

T = TypeVar("T")


def run_with_restarts(make_attempt: Callable[[int], T], *,
                      max_restarts: int = 0, backoff_s: float = 5.0,
                      backoff_factor: float = 2.0,
                      max_backoff_s: float = 300.0,
                      restart_window_s: float = 0.0, jitter: bool = True,
                      checkpoint_dir: str | None = None,
                      on_failure: Callable[[int, BaseException], None]
                      | None = None,
                      _rng: random.Random | None = None) -> T:
    """``make_attempt(attempt_index)`` until it returns, restarting on an
    exception while the budget allows; the last failure is raised when it
    does not. ``make_attempt`` builds a fresh run each call (a new Trainer
    with ``resume``); only the checkpoint survives a failed attempt.
    KeyboardInterrupt is never retried, ``Preempted`` passes through.

    - ``restart_window_s > 0``: ``max_restarts`` restarts within any
      window of that many seconds (older ones expire); 0 is a lifetime
      budget.
    - ``jitter``: each delay is uniform in ``[backoff_s, previous delay x
      backoff_factor]``, capped at ``max_backoff_s``; without it the delay
      grows by ``backoff_factor``.
    - ``checkpoint_dir``: each retry logs and records the verified step it
      will resume from."""
    rng = _rng or random.Random()
    attempt = 0
    delay = backoff_s
    restart_times: deque[float] = deque()
    while True:
        try:
            return make_attempt(attempt)
        except KeyboardInterrupt:
            raise
        except Preempted:
            log0("preempted: exiting resumable (code 75) without spending "
                 "a restart")
            raise
        except Exception as e:
            if on_failure is not None:
                on_failure(attempt, e)
            now = time.monotonic()
            if restart_window_s > 0:
                while (restart_times
                       and now - restart_times[0] > restart_window_s):
                    restart_times.popleft()
                will_retry = len(restart_times) < max_restarts
            else:
                will_retry = attempt < max_restarts
            resume_step = None
            if will_retry and checkpoint_dir is not None:
                from pytorch_distributed_training_tpu_torch.train.checkpoint import (  # noqa: E501
                    verified_latest_step,
                )

                resume_step = verified_latest_step(checkpoint_dir)
            # the failed attempt's registry and sink are still installed
            # (the Trainer leaves the stream open on a crash), so the
            # restart lands in the stream the attempt was writing
            reg = get_registry()
            if will_retry:
                reg.inc("supervisor/restarts")
            reg.emit({
                "record": "restart",
                "attempt": attempt,
                "error": type(e).__name__,
                "message": str(e)[:500],
                "will_retry": will_retry,
                **({"resume_step": resume_step}
                   if checkpoint_dir is not None else {}),
            })
            if not will_retry:
                raise
            restart_times.append(now)
            sleep_s = (rng.uniform(backoff_s, max(backoff_s,
                                                  delay * backoff_factor))
                       if jitter else delay)
            sleep_s = min(sleep_s, max_backoff_s)
            log0(f"attempt {attempt} failed ({type(e).__name__}: {e}); "
                 f"restarting from "
                 + (f"verified checkpoint step {resume_step} "
                    if resume_step is not None else "latest checkpoint ")
                 + f"in {sleep_s:.1f}s")
            time.sleep(sleep_s)
            delay = min(sleep_s if jitter else delay * backoff_factor,
                        max_backoff_s)
            delay = max(delay, backoff_s)
            attempt += 1
