"""Training and serving telemetry (counterpart: the JAX package's
``telemetry/``):

- ``registry.MetricsRegistry``: counters, gauges and timer histograms that
  instrumentation sites record into; a process-wide default registry lets
  the checkpointer, the supervisor and the fault hooks record without
  plumbing;
- ``sink.JsonlSink``: the rank-0 append-only JSONL stream
  (``--metrics-dir``) of the JAX package's record types and keys, which
  ``scripts/summarize_metrics.py`` reads;
- ``straggler.epoch_straggler_stats``: each rank's step-time stats
  gathered over the batch group at an epoch's end, so rank 0 names the
  slowest;
- ``spans.Tracer``: a request's span tree (``serve`` -> ``queue`` /
  ``prefill`` / ``decode``), emitted by the engine at finish;
- ``flight.FlightRecorder``: the ring of recent tick summaries, dumped on a
  watchdog stall, a fatal tick, a SIGTERM drain or ``GET /debug/flight``;
- ``slo.BurnRateMonitor``: per-tier error-budget burn over sliding
  windows (``slo_burn`` records), an optional brownout input.
"""
