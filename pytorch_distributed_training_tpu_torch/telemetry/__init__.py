"""Training telemetry (counterpart: the JAX package's ``telemetry/``
registry, sink and straggler modules):

- ``registry.MetricsRegistry``: counters, gauges and timer histograms that
  instrumentation sites record into; a process-wide default registry lets
  the checkpointer, the supervisor and the fault hooks record without
  plumbing;
- ``sink.JsonlSink``: the rank-0 append-only JSONL stream
  (``--metrics-dir``) of the JAX package's record types and keys, which
  ``scripts/summarize_metrics.py`` reads;
- ``straggler.epoch_straggler_stats``: each rank's step-time stats
  gathered over the batch group at an epoch's end, so rank 0 names the
  slowest.

The serving observability layers (spans, flight recorder, SLO burn) wait
in ROADMAP.md (queue 1, item 5).
"""
