"""Request-span tracing: one causal tree a request over the JSONL sink
(counterpart: the JAX package's ``telemetry/spans.py``, which needs no
JAX; the port keeps its own copy, the record keys unchanged, so
``scripts/summarize_metrics.py`` and ``scripts/trace_view.py`` read the
port's stream).

- **trace id** = the request's ``X-Request-Id``: every span of one
  request carries it, across processes.
- **span** = one named phase with a parent span id, ``time.monotonic()``
  start and end stamps (exact durations within a process) and wall-clock
  stamps derived at emit time (cross-process alignment only, never used
  for arithmetic).
- **phases** (replica side): ``serve`` is the root, and its children
  ``queue`` / ``prefill`` / ``decode`` tile the request's lifetime
  exactly (submit to admit, admit to first token, first token to finish),
  so the phase sums reconcile with the request's total. ``admission``
  (page reservation) nests under prefill; ``swap_overlap`` and
  ``brownout_clamp`` annotate requests a weight swap or an overload clamp
  touched. Router side: ``request`` -> ``attempt`` -> ``hedge``.

``Tracer`` is thread-safe (front-end threads begin what the engine thread
ends); its id counter sits behind the registry's ``telemetry.spans``
lock (``analysis/concurrency``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
import uuid
from typing import Optional

from pytorch_distributed_training_tpu_torch.analysis import concurrency
from pytorch_distributed_training_tpu_torch.telemetry.registry import (
    get_registry,
)


#: replica-side phases that tile a request's submit->finish interval; the
#: summarize/bench reconciliation sums exactly these against the root span
REQUEST_PHASES = ("queue", "prefill", "decode")

#: every span name any instrumentation site emits (trace_view legend)
SPAN_NAMES = (
    "request", "attempt", "hedge",              # router side
    "serve", "queue", "admission", "prefill",   # replica side
    "decode", "swap_overlap", "brownout_clamp",
)


@dataclasses.dataclass
class Span:
    """One live (or retroactively constructed) span; ``Tracer.end`` emits
    it as a ``span`` record and returns it closed."""

    trace: str
    span: str
    name: str
    parent: Optional[str] = None
    t0: float = 0.0                 # time.monotonic()
    t1: Optional[float] = None
    attrs: dict = dataclasses.field(default_factory=dict)

    @property
    def dur_s(self) -> Optional[float]:
        return None if self.t1 is None else max(0.0, self.t1 - self.t0)


class Tracer:
    """Span factory + emitter bound to one MetricsRegistry.

    ``begin``/``end`` take explicit ``t0``/``t1`` overrides so loop-
    structured phases (the engine's tick loop stamps phase boundaries on
    the request as it goes) can emit their spans retroactively with exact
    monotonic bounds; ``span()`` is the context-manager form for linear
    code (the router). Span ids are unique across processes (random
    per-tracer prefix + a counter), which is what lets a replica parent
    its ``serve`` span under a router-generated ``attempt`` span id
    carried over HTTP.
    """

    def __init__(self, *, registry=None, component: str = "",
                 now_fn=None, wall_fn=None):
        if registry is None:
            registry = get_registry()
        self._registry = registry
        self.component = component
        self._now = now_fn if now_fn is not None else time.monotonic
        self._wall = wall_fn if wall_fn is not None else time.time
        # begin() is called from front-end threads while end() runs on the
        # engine thread: the id counter is the shared state
        self._lock = concurrency.lock("telemetry.spans")
        self._prefix = uuid.uuid4().hex[:6]
        self._seq = 0
        self.emitted = 0

    def _span_id(self) -> str:
        with self._lock:
            self._seq += 1
            n = self._seq
        head = self.component or "span"
        return f"{head}-{self._prefix}-{n}"

    def begin(self, trace: str, name: str, *, parent: Optional[str] = None,
              t0: Optional[float] = None, attrs: Optional[dict] = None,
              ) -> Span:
        return Span(
            trace=str(trace), span=self._span_id(), name=name,
            parent=parent, t0=self._now() if t0 is None else float(t0),
            attrs=dict(attrs or {}),
        )

    def end(self, span: Span, *, t1: Optional[float] = None,
            attrs: Optional[dict] = None) -> Span:
        span.t1 = self._now() if t1 is None else float(t1)
        if attrs:
            span.attrs.update(attrs)
        # wall-clock bounds derived from the monotonic offsets at emit
        # time: cross-process waterfall alignment, never duration math
        mono, wall = self._now(), self._wall()
        with self._lock:
            self.emitted += 1
        self._registry.emit({
            "record": "span",
            "trace": span.trace,
            "span": span.span,
            "parent": span.parent,
            "name": span.name,
            "component": self.component or None,
            "t0_s": span.t0,
            "t1_s": span.t1,
            "dur_s": span.dur_s,
            "wall_t0": wall - (mono - span.t0),
            "wall_t1": wall - (mono - span.t1),
            "attrs": span.attrs,
        })
        return span

    def event(self, trace: str, name: str, *, parent: Optional[str] = None,
              t: Optional[float] = None, attrs: Optional[dict] = None,
              ) -> Span:
        """A zero-duration marker span (e.g. a brownout clamp applied at
        admission)."""
        s = self.begin(trace, name, parent=parent, t0=t, attrs=attrs)
        return self.end(s, t1=s.t0)

    @contextlib.contextmanager
    def span(self, trace: str, name: str, *, parent: Optional[str] = None,
             attrs: Optional[dict] = None):
        s = self.begin(trace, name, parent=parent, attrs=attrs)
        try:
            yield s
        finally:
            self.end(s)


# --------------------------------------------------------- trace analysis


def spans_by_trace(records) -> dict:
    """Group ``span`` records (any iterable of record dicts) by trace id,
    preserving emission order — the merge step for fleet-side analysis."""
    out: dict[str, list] = {}
    for rec in records:
        if rec.get("record") == "span" and rec.get("trace"):
            out.setdefault(str(rec["trace"]), []).append(rec)
    return out


def trace_summary(spans: list) -> dict:
    """Structural verdict for ONE trace's span list.

    A trace is **complete** when it has exactly one root (a span with no
    parent), the root is closed, every span is closed, and every parent id
    resolves to a span within the trace (unresolved parents are orphans —
    the signature of a replica stream that wasn't merged, or a dropped
    root). ``phase_sum_s``/``root_dur_s`` carry the tiling reconciliation
    for the replica phases (summed across replicas for hedged traces;
    compared per-serve-span by callers that need the 5% gate)."""
    roots = [s for s in spans if not s.get("parent")]
    ids = {s.get("span") for s in spans}
    orphans = [
        s for s in spans
        if s.get("parent") and s.get("parent") not in ids
    ]
    open_spans = [s for s in spans if s.get("t1_s") is None]
    serve = [s for s in spans if s.get("name") == "serve"]
    phase_sum = sum(
        s.get("dur_s") or 0.0 for s in spans
        if s.get("name") in REQUEST_PHASES
    )
    serve_dur = sum(s.get("dur_s") or 0.0 for s in serve)
    return {
        "spans": len(spans),
        "roots": len(roots),
        "orphans": len(orphans),
        "open": len(open_spans),
        "complete": (
            len(roots) == 1 and not orphans and not open_spans
        ),
        "root_name": roots[0].get("name") if len(roots) == 1 else None,
        "root_dur_s": roots[0].get("dur_s") if len(roots) == 1 else None,
        "serve_spans": len(serve),
        "serve_dur_s": serve_dur or None,
        "phase_sum_s": phase_sum or None,
        "phase_sum_ok": (
            abs(phase_sum - serve_dur) <= 0.05 * serve_dur
            if serve_dur else None
        ),
    }


def trace_coverage(records, *, accepted_ids=None) -> dict:
    """Fleet-level span coverage over an iterable of records.

    ``accepted_ids`` (when given) restricts the verdict to those trace ids
    — the bench gate: every ACCEPTED request must yield a complete,
    root-closed tree with zero orphans and phase sums reconciling within
    5% of the serve span total. Returns counts plus the offending trace
    ids so a failing gate names its evidence."""
    traces = spans_by_trace(records)
    if accepted_ids is not None:
        wanted = {str(i) for i in accepted_ids}
        traces = {t: s for t, s in traces.items() if t in wanted}
        missing = sorted(wanted - set(traces))
    else:
        missing = []
    complete = 0
    orphan_spans = 0
    incomplete: list[str] = []
    phase_sum_bad: list[str] = []
    for trace, spans in sorted(traces.items()):
        v = trace_summary(spans)
        orphan_spans += v["orphans"]
        if v["complete"]:
            complete += 1
        else:
            incomplete.append(trace)
        if v["phase_sum_ok"] is False:
            phase_sum_bad.append(trace)
    total = len(traces) + len(missing)
    return {
        "traces": total,
        "complete": complete,
        "incomplete": incomplete + missing,
        "orphan_spans": orphan_spans,
        "phase_sum_bad": phase_sum_bad,
        "coverage": (complete / total) if total else 1.0,
    }
