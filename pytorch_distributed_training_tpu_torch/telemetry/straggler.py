"""Straggler detection from per-rank step times (counterpart: the JAX
package's ``telemetry/straggler.py``).

Every step is a barrier: the gradient all-reduce cannot finish until the
slowest rank has stepped, so a rank that assembles batches slowly taxes
every rank's step time, and rank 0's own clock cannot tell which rank it
was. At each epoch's end the Trainer gathers each rank's step-time stats
over the batch group (``comms/collectives.host_allgather``) and rank 0
names the slowest: ``wait_skew_s`` is the mean step time the run would
shed if the slowest rank matched the fastest. One process reports over
itself alone (skew 0), so the record's schema is the same everywhere.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from pytorch_distributed_training_tpu_torch.comms.collectives import (
    host_allgather,
)

# per-rank stat vector: [mean, max, min, count, data_wait_mean]
_STAT_WIDTH = 5


def epoch_straggler_stats(step_times: Sequence[float],
                          data_waits: Sequence[float] | None = None, *,
                          group=None, device=None) -> dict:
    """Gather this rank's step-time stats over ``group`` (a collective:
    every rank of it calls once an epoch) and return the summary."""
    st = np.asarray(step_times, np.float64)
    dw = np.asarray(data_waits if data_waits is not None else [], np.float64)
    local = np.array([
        st.mean() if st.size else 0.0,
        st.max() if st.size else 0.0,
        st.min() if st.size else 0.0,
        float(st.size),
        dw.mean() if dw.size else 0.0,
    ], np.float64)
    gathered = host_allgather(local, group, device).reshape(-1, _STAT_WIDTH)
    means = gathered[:, 0]
    slowest = int(np.argmax(means))
    fastest = int(np.argmin(means))
    return {
        "hosts": int(gathered.shape[0]),
        "slowest_host": slowest,
        "slowest_host_mean_step_s": float(means[slowest]),
        "fastest_host": fastest,
        "fastest_host_mean_step_s": float(means[fastest]),
        "wait_skew_s": float(means[slowest] - means[fastest]),
        "slowest_host_max_step_s": float(gathered[slowest, 1]),
        "slowest_host_data_wait_mean_s": float(gathered[slowest, 4]),
        "per_host_mean_step_s": [float(m) for m in means],
    }
