"""Threaded serving front-end over the decode engine (counterpart: the JAX
package's ``serve/server.py``).

``InferenceServer`` owns the request queue, the engine and the serve-loop
thread (the engine is single-threaded by contract; front-end threads only
touch the queue). Two transports, with the JAX package's events and
status codes:

- ``serve_stdio``: JSONL in / JSONL out: ``token`` per generated token,
  then one ``done`` per request (``error`` for a rejected line or
  request).
- ``make_http_server``: a ``ThreadingHTTPServer``. ``POST /generate``
  streams the same JSONL events over a close-delimited HTTP/1.0 response;
  a full queue is 429 with ``Retry-After`` (``retry_after_estimate``: the
  queue over the observed drain rate), and every response carries the
  request's ``X-Request-Id``. The brownout ladder sheds batch (429) and
  at its last level interactive (503) requests, and clamps output
  budgets. ``GET /healthz`` is 200 ``ready``, or 503 ``draining`` while a
  shutdown finishes in-flight work, or 503 ``unhealthy`` when the loop
  died or its tick heartbeat is older than ``stall_timeout_s``; ``GET
  /stats`` the engine's counts; ``GET /debug/flight`` dumps and returns
  the flight recorder; ``POST /swap`` (with a ``HotSwapManager``
  attached, ``serve/hotswap.py``) swaps to a named checkpoint step.

Shutdown: ``close(drain=True)`` stops admissions and runs the engine until
in-flight work completes; ``close(drain=False)`` cancels it. Either way
every waiter's ``done`` event fires; a failed loop dumps the flight
recorder (``fatal_tick``).

Tensor parallelism (``EngineConfig.tp > 1``): the server runs on the model
group's rank 0, its engine the leader (``shard``: the model axis's
``AxisShard``); every other rank runs ``serve/tp_worker.run_follower``
instead, which returns at the leader's stop message. ``close`` and the
serve loop's failure path send that message (``DecodeEngine.shutdown``),
so no follower waits on a leader that has stopped.
"""

from __future__ import annotations

import itertools
import json
import math
import threading
import time
import uuid
from typing import Optional

import numpy as np

from pytorch_distributed_training_tpu_torch.serve.engine import (
    DecodeEngine,
    EngineConfig,
)
from pytorch_distributed_training_tpu_torch.serve.queue import (
    TIERS,
    BackpressureError,
    GenRequest,
    RequestQueue,
)
from pytorch_distributed_training_tpu_torch.telemetry import flight
from pytorch_distributed_training_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_IDLE_WAIT_S = 0.02


class InferenceServer:
    """Queue + engine + serve-loop thread, one object. ``tier_deadlines``:
    a tier's deadline (``interactive``, ``batch``), else
    ``default_deadline_s``; ``brownout``, ``slo``, ``registry``,
    ``guards`` and ``replica_name`` go to the engine; ``stall_timeout_s`` is the
    heartbeat age ``health`` calls ``unhealthy``."""

    def __init__(self, model, config: EngineConfig, *, device="cuda",
                 queue_depth: int = 16,
                 default_deadline_s: Optional[float] = None,
                 tier_deadlines: Optional[dict] = None,
                 tier_weights: Optional[dict] = None, brownout=None,
                 registry=None, stall_timeout_s: float = 10.0, shard=None,
                 weights_step: Optional[int] = None, draft_model=None,
                 slo=None, replica_name: Optional[str] = None,
                 guards=None):
        if tier_deadlines is not None:
            bad = set(tier_deadlines) - set(TIERS)
            if bad:
                raise ValueError(f"unknown tiers in tier_deadlines: {bad}")
        self.queue = RequestQueue(
            max_depth=queue_depth,
            prompt_buckets=config.prompt_buckets,
            max_new_tokens=config.max_new_tokens,
            tier_weights=tier_weights,
        )
        self.engine = DecodeEngine(
            model, config, self.queue, device=device, shard=shard,
            weights_step=weights_step, draft_model=draft_model,
            registry=registry, brownout=brownout, slo=slo,
            replica_name=replica_name, guards=guards)
        self.registry = self.engine._registry
        self.default_deadline_s = default_deadline_s
        self.tier_deadlines = dict(tier_deadlines or {})
        self.stall_timeout_s = stall_timeout_s
        # the replica's hot-swap executor (serve/hotswap.py), attached by
        # the CLI with a checkpoint directory; enables POST /swap
        self.hotswap = None
        self._ids = itertools.count()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._drain_mode = threading.Event()
        self._drain_requested = threading.Event()
        self._loop_failed = threading.Event()

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "InferenceServer":
        if self._thread is not None:
            raise RuntimeError("server already started")
        self._thread = threading.Thread(
            target=self._loop, name="pdt-serve-loop", daemon=True
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        try:
            while True:
                if self._stop.is_set():
                    if not (
                        self._drain_mode.is_set() and self.engine.has_work()
                    ):
                        return
                worked = self.engine.tick()
                if not worked and not self._stop.is_set():
                    self.queue.wait_for_work(_IDLE_WAIT_S)
        except Exception:
            # A tick must never die silently: waiters block on request
            # ``done`` events, so fail them all (cancelled, never hung) and
            # refuse new submissions.
            logger.exception(
                "serve loop died; cancelling all in-flight requests"
            )
            self._loop_failed.set()     # /healthz: unhealthy
            try:
                # what led up to the fatal tick
                self.engine.flight.dump("fatal_tick")
            except Exception:  # best-effort post-mortem
                pass
            self.queue.close()
            try:
                self.engine.cancel_all()
            except Exception:  # best-effort cleanup after a failed loop
                logger.exception("cancel_all after serve-loop failure failed")
            try:
                self.engine.shutdown()
            except Exception:  # best-effort: the followers' group may be gone
                logger.exception("stopping the followers after serve-loop "
                                 "failure failed")

    def close(self, *, drain: bool = True, timeout: float = 60.0) -> None:
        """Stop serving. ``drain=True`` finishes in-flight and queued work
        first; ``drain=False`` cancels it. Idempotent. ``health`` says
        ``draining`` from the first line on."""
        if self.hotswap is not None:
            self.hotswap.close()
        self._drain_requested.set()
        self.queue.close()
        if drain:
            self._drain_mode.set()
        else:
            self._drain_mode.clear()
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout)
            if thread.is_alive():
                # the loop thread still owns the engine: leave it alone
                logger.error(
                    "serve loop failed to stop within %.1fs; "
                    "skipping cancel_all", timeout,
                )
                return
        if not drain:
            self.engine.cancel_all()
        self.engine.shutdown()
        # a closed server's ring holds no future evidence
        flight.unregister(self.engine.flight)

    # ------------------------------------------------------------ submission

    def submit(self, prompt_ids, *, max_new_tokens: int,
               temperature: float = 0.0, top_k: int = 0,
               eot_id: Optional[int] = None, seed: int = 0,
               deadline_s: Optional[float] = None,
               tier: str = "interactive", tenant: Optional[str] = None,
               stream=None, on_finish=None,
               request_id: Optional[str] = None,
               spec: Optional[bool] = None,
               trace_parent: Optional[str] = None,
               clamped_from: Optional[int] = None) -> GenRequest:
        """Enqueue one request (any thread). Raises ``BackpressureError``
        when the queue is full; the request's ``done`` event fires at every
        terminal state. ``tier``: its SLO lane (``interactive``,
        ``batch``); ``tenant``: who it is charged to (None: nobody);
        ``spec`` opts it in or out of speculative decoding (None: the
        engine's default). The deadline is ``deadline_s``, else the
        tier's, else ``default_deadline_s``."""
        if deadline_s is None:
            deadline_s = self.tier_deadlines.get(tier,
                                                 self.default_deadline_s)
        req = GenRequest(
            id=request_id or f"r{next(self._ids)}",
            prompt_ids=np.asarray(prompt_ids, np.int32).reshape(-1),
            max_new_tokens=max_new_tokens,
            temperature=temperature,
            top_k=top_k,
            tier=tier,
            tenant=tenant,
            eot_id=eot_id,
            seed=seed,
            deadline_s=deadline_s,
            stream=stream,
            on_finish=on_finish,
            spec=spec,
            trace_parent=trace_parent,
            clamped_from=clamped_from,
        )
        return self.queue.submit(req)

    def attach_hotswap(self, manager) -> None:
        """Wire a ``HotSwapManager`` in: enables ``POST /swap`` and adds
        its counts to ``stats()``; ``close()`` then closes it."""
        self.hotswap = manager

    def stats(self) -> dict:
        stats = self.engine.stats()
        if self.hotswap is not None:
            stats.update(self.hotswap.stats())
        return stats

    # ---------------------------------------------------------------- health

    @property
    def draining(self) -> bool:
        return self._drain_requested.is_set() or self.queue.closed

    def loop_dead(self) -> bool:
        """True when the serve loop can no longer finish requests."""
        if self._loop_failed.is_set():
            return True
        thread = self._thread
        return thread is not None and not thread.is_alive()

    def health(self) -> dict:
        """Liveness and load: ``state`` is ``ready``, ``draining`` (a
        shutdown finishing in-flight work, nothing new admitted) or
        ``unhealthy`` (the loop died, or its tick heartbeat is older than
        ``stall_timeout_s``: a wedged loop, which the HTTP threads
        answering this cannot see otherwise)."""
        thread = self._thread
        if self._loop_failed.is_set():
            state = "unhealthy"
        elif self.draining:
            state = "draining"
        elif thread is not None and not thread.is_alive():
            state = "unhealthy"     # the loop exited without close()
        elif (thread is not None
              and time.monotonic() - self.engine.last_tick_t
              > self.stall_timeout_s):
            state = "unhealthy"     # the heartbeat is stale
        else:
            state = "ready"
        shared, free = self.engine.page_split()
        return {
            "state": state,
            "draining": self.draining,
            "queue_depth": self.queue.depth(),
            "slot_occupancy": self.engine.slot_occupancy(),
            "num_slots": self.engine.config.num_slots,
            "queue_capacity": self.queue.max_depth,
            "page_occupancy": self.engine.page_occupancy(),
            "kv_pages_shared": shared,
            "kv_pages_free": free,
            "brownout_level": (self.engine.brownout.level
                               if self.engine.brownout is not None else 0),
            "weights_step": self.engine.weights_step,
            "swapping": bool(self.hotswap is not None
                             and self.hotswap.swapping),
        }


# ------------------------------------------------------------------- stdio


def _decode_text(tokenizer, tokens, eot_id) -> str:
    ids = list(tokens)
    if eot_id is not None and ids and ids[-1] == eot_id:
        ids = ids[:-1]
    return tokenizer.decode(ids)


def serve_stdio(server: InferenceServer, tokenizer, in_stream,
                out_stream) -> int:
    """JSONL request/response loop until EOF; returns requests served.

    Input lines: ``{"prompt": str, "max_new_tokens"?: int,
    "temperature"?: float, "top_k"?: int, "seed"?: int, "deadline_s"?:
    float, "id"?: str, "spec"?: bool, "tier"?: str, "tenant"?: str}``
    (``spec``: the request's speculative-decoding opt-in/out; ``tier``:
    ``interactive``, the default, or ``batch``; ``tenant``: a non-empty
    string the page quota charges; the queue refuses other values with
    an ``error`` event). Output events (one JSON per line,
    interleaved across requests): ``{"id", "event": "token", "token_id",
    "text"}``,
    ``{"id", "event": "done", "status", "finish_reason", "text",
    "new_tokens", "ttft_s"}`` and ``{"id", "event": "error", "error"}``.
    """
    wlock = threading.Lock()
    eot_id = getattr(tokenizer, "eot_id", None)

    def write(obj: dict) -> None:
        with wlock:
            out_stream.write(json.dumps(obj) + "\n")
            out_stream.flush()

    def on_token(req: GenRequest, token: int) -> None:
        if eot_id is not None and token == eot_id:
            return
        write({
            "id": req.id,
            "event": "token",
            "token_id": token,
            "text": tokenizer.decode([token]),
        })

    def on_finish(req: GenRequest) -> None:
        write({
            "id": req.id,
            "event": "done",
            "status": req.status,
            "finish_reason": req.finish_reason,
            "text": _decode_text(tokenizer, req.tokens, eot_id),
            "new_tokens": len(req.tokens),
            "ttft_s": (
                req.first_token_t - req.submit_t
                if req.first_token_t is not None
                else None
            ),
        })

    def await_done(req: GenRequest) -> None:
        # bounded wait + liveness re-check: a dead serve loop surfaces as
        # an error event instead of hanging this waiter
        while not req.done.wait(1.0):
            if server.loop_dead() and not req.done.is_set():
                write({"id": req.id, "event": "error",
                       "error": "serve loop died with the request in flight"})
                return

    pending: list[GenRequest] = []
    served = 0
    for line in in_stream:
        line = line.strip()
        if not line:
            continue
        try:
            msg = json.loads(line)
            prompt = msg["prompt"]
            if not isinstance(prompt, str):
                raise TypeError(
                    f"prompt must be a string, got {type(prompt).__name__}"
                )
            spec = msg.get("spec")
            if spec is not None and not isinstance(spec, bool):
                raise TypeError(
                    f"spec must be a boolean, got {type(spec).__name__}"
                )

        except (json.JSONDecodeError, KeyError, TypeError) as e:
            write({"event": "error", "error": f"bad request line: {e}"})
            continue
        ids = tokenizer.text_ids(prompt)
        if not ids:
            write({"id": msg.get("id"), "event": "error",
                   "error": "empty prompt after tokenization"})
            continue
        try:
            req = server.submit(
                ids,
                max_new_tokens=int(
                    msg.get("max_new_tokens", server.queue.max_new_tokens)
                ),
                temperature=float(msg.get("temperature", 0.0)),
                top_k=int(msg.get("top_k", 0)),
                eot_id=eot_id,
                seed=int(msg.get("seed", 0)),
                deadline_s=msg.get("deadline_s"),
                tier=msg.get("tier", "interactive"),
                tenant=msg.get("tenant"),
                stream=on_token,
                on_finish=on_finish,
                request_id=msg.get("id"),
                spec=spec,
            )
        except (BackpressureError, ValueError, RuntimeError) as e:
            write({"id": msg.get("id"), "event": "error",
                   "error": f"{type(e).__name__}: {e}"})
            continue
        pending.append(req)
        served += 1
    for req in pending:
        await_done(req)
    return served


# -------------------------------------------------------------------- http


#: Retry-After FLOORS for 429 (queue full — drains in request time) and
#: 503 while draining (a replacement replica needs to boot). The advertised
#: value is a live estimate — queue depth / observed drain rate — clamped
#: between the path's floor and ``RETRY_AFTER_CEILING_S``; the floors keep
#: their old values so an engine with no drain history answers exactly what
#: the hard-coded constants used to say.
BACKPRESSURE_RETRY_AFTER_S = 1
DRAINING_RETRY_AFTER_S = 5
RETRY_AFTER_CEILING_S = 30


def retry_after_estimate(server: InferenceServer, *, floor: int) -> int:
    """Honest Retry-After seconds: how long the CURRENT queue takes to
    drain at the observed finish rate, bounded to [floor, ceiling]. With no
    drain history yet (cold engine) the floor is the only defensible
    number. Clients and the router forward this value verbatim, so a
    storm's rejections carry real backoff guidance instead of a constant
    that is wrong in both directions."""
    rate = server.engine.drain_rate
    if rate <= 0.0:
        return floor
    est = math.ceil(server.queue.depth() / rate)
    return max(floor, min(RETRY_AFTER_CEILING_S, est))


def make_http_server(server: InferenceServer, tokenizer, host="127.0.0.1",
                     port: int = 0):
    """A localhost ``ThreadingHTTPServer`` bound to ``(host, port)`` (port 0
    picks a free one; read it back from ``.server_address``). The caller
    runs ``serve_forever`` (blocking) or a thread around it.

    Every response carries ``X-Request-Id`` (the caller's header, else the
    body ``id``, else generated) and the id rides the request through
    queue → engine → telemetry, so one request is one join key across the
    router's, the replica's and the client's views of it. The returned
    httpd object exposes ``active_streams`` — the number of /generate
    responses still streaming — which the drain path waits on before
    tearing the process down."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    eot_id = getattr(tokenizer, "eot_id", None)

    class Handler(BaseHTTPRequestHandler):
        # close-delimited streaming bodies (no chunked framing needed)
        protocol_version = "HTTP/1.0"

        def log_message(self, fmt, *args):  # route through framework logging
            logger.debug("http: " + fmt, *args)

        def _json(self, code: int, obj: dict, headers: dict = None) -> None:
            body = (json.dumps(obj) + "\n").encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, str(v))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                h = server.health()
                if h["state"] == "ready":
                    self._json(200, h)
                else:
                    # 503, not 200-with-a-sad-body: routers and external
                    # LBs act on status codes, not on parsed payloads
                    self._json(503, h, headers={
                        "Retry-After": retry_after_estimate(
                            server, floor=DRAINING_RETRY_AFTER_S
                        ),
                    })
            elif self.path == "/stats":
                self._json(200, server.stats())
            elif self.path == "/debug/flight":
                # on-demand post-mortem: emit a flight_dump record on the
                # metrics stream AND return the full ring to the caller
                server.engine.flight.dump("debug_endpoint")
                self._json(200, {
                    "entries": server.engine.flight.snapshot(),
                    **server.engine.flight.stats(),
                })
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path == "/swap":
                self._swap()
                return
            if self.path != "/generate":
                self._json(404, {"error": f"no route {self.path}"})
                return
            rid = self.headers.get("X-Request-Id")
            try:
                n = int(self.headers.get("Content-Length", "0"))
                msg = json.loads(self.rfile.read(n) or b"{}")
                rid = rid or msg.get("id") or uuid.uuid4().hex[:12]
                prompt = msg["prompt"]
                if not isinstance(prompt, str):
                    raise TypeError(
                        f"prompt must be a string, got {type(prompt).__name__}"
                    )
            except (json.JSONDecodeError, KeyError, ValueError,
                    TypeError) as e:
                self._json(400, {"error": f"bad request: {e}", "id": rid},
                           headers={"X-Request-Id": rid} if rid else None)
                return
            if server.draining:
                self._json(503, {
                    "error": "replica draining", "state": "draining",
                    "id": rid,
                }, headers={
                    "Retry-After": retry_after_estimate(
                        server, floor=DRAINING_RETRY_AFTER_S
                    ),
                    "X-Request-Id": rid,
                })
                return
            tier = msg.get("tier", "interactive")
            if tier not in TIERS:
                self._json(400, {
                    "error": f"unknown tier {tier!r} (expected one of "
                             f"{list(TIERS)})",
                    "id": rid,
                }, headers={"X-Request-Id": rid})
                return
            tenant = msg.get("tenant")
            if tenant is not None and (
                not isinstance(tenant, str) or not tenant
            ):
                self._json(400, {
                    "error": f"tenant must be a non-empty string, got "
                             f"{tenant!r}",
                    "id": rid,
                }, headers={"X-Request-Id": rid})
                return
            brownout = server.engine.brownout
            if brownout is not None and brownout.sheds(tier):
                # the degradation ladder's explicit rejection: batch sheds
                # first (429, plain backpressure semantics), interactive
                # only at the final fail-fast rung (503 — the service is
                # degraded, not the request). Both carry the live estimate.
                level = brownout.level_name()
                server.registry.inc(f"serve/shed_{tier}")
                if server.engine.slo is not None:
                    # a shed is an availability miss (the deadline ratio
                    # only covers requests that were actually admitted)
                    server.engine.slo.observe(tier, available=False)
                server.registry.emit({
                    "record": "serve_shed",
                    "id": rid,
                    "tier": tier,
                    "level": level,
                })
                self._json(429 if tier == "batch" else 503, {
                    "error": f"brownout ({level}): shedding {tier} traffic",
                    "brownout": level,
                    "tier": tier,
                    "retryable": True,
                    "id": rid,
                }, headers={
                    "Retry-After": retry_after_estimate(
                        server, floor=BACKPRESSURE_RETRY_AFTER_S
                    ),
                    "X-Request-Id": rid,
                })
                return
            max_new = int(
                msg.get("max_new_tokens", server.queue.max_new_tokens)
            )
            clamped_from = None
            if brownout is not None:
                clamped = brownout.clamp(max_new)
                if clamped != max_new:
                    server.registry.inc("serve/brownout_clamped")
                    clamped_from = max_new
                max_new = clamped
            ids = tokenizer.text_ids(prompt)
            if not ids:
                self._json(400, {"error": "empty prompt after tokenization",
                                 "id": rid},
                           headers={"X-Request-Id": rid})
                return

            import queue as _q

            events: _q.Queue = _q.Queue()

            def on_token(req, token):
                if eot_id is not None and token == eot_id:
                    return
                events.put({
                    "id": req.id,
                    "event": "token",
                    "token_id": token,
                    "text": tokenizer.decode([token]),
                })

            def on_finish(req):
                events.put({
                    "id": req.id,
                    "event": "done",
                    "status": req.status,
                    "finish_reason": req.finish_reason,
                    "text": _decode_text(tokenizer, req.tokens, eot_id),
                    "new_tokens": len(req.tokens),
                })
                events.put(None)

            try:
                server.submit(
                    np.asarray(ids, np.int32),
                    max_new_tokens=max_new,
                    temperature=float(msg.get("temperature", 0.0)),
                    top_k=int(msg.get("top_k", 0)),
                    eot_id=eot_id,
                    seed=int(msg.get("seed", 0)),
                    deadline_s=msg.get("deadline_s"),
                    tier=tier,
                    tenant=tenant,
                    stream=on_token,
                    on_finish=on_finish,
                    request_id=rid,
                    # router attempt span id: the replica's serve span
                    # parents under it, so hedged/retried attempts stay
                    # children of ONE trace
                    trace_parent=self.headers.get("X-Parent-Span"),
                    clamped_from=clamped_from,
                )
            except BackpressureError as e:
                # backpressure is retryable BY CONSTRUCTION — say when
                self._json(429, {"error": str(e), "id": rid},
                           headers={
                               "Retry-After": retry_after_estimate(
                                   server, floor=BACKPRESSURE_RETRY_AFTER_S
                               ),
                               "X-Request-Id": rid,
                           })
                return
            except RuntimeError as e:
                # submit raced the queue closing: draining, not client error
                self._json(503, {"error": f"{type(e).__name__}: {e}",
                                 "id": rid},
                           headers={
                               "Retry-After": retry_after_estimate(
                                   server, floor=DRAINING_RETRY_AFTER_S
                               ),
                               "X-Request-Id": rid,
                           })
                return
            except ValueError as e:
                self._json(400, {"error": f"{type(e).__name__}: {e}",
                                 "id": rid},
                           headers={"X-Request-Id": rid})
                return
            with self.server.streams_lock:
                self.server.active_streams += 1
            try:
                self.send_response(200)
                self.send_header("Content-Type", "application/jsonl")
                self.send_header("X-Request-Id", rid)
                self.end_headers()
                while True:
                    # bounded pop + liveness re-check: if the serve loop
                    # died without finishing this request, close the
                    # stream with an explicit terminal error instead of
                    # holding the connection open forever
                    try:
                        ev = events.get(timeout=1.0)
                    except _q.Empty:
                        if server.loop_dead() and events.empty():
                            self.wfile.write((json.dumps({
                                "id": rid,
                                "event": "error",
                                "error": "serve loop died mid-stream",
                                "retryable": True,
                            }) + "\n").encode())
                            self.wfile.flush()
                            break
                        continue
                    if ev is None:
                        break
                    self.wfile.write((json.dumps(ev) + "\n").encode())
                    self.wfile.flush()
            finally:
                with self.server.streams_lock:
                    self.server.active_streams -= 1

        def _swap(self) -> None:
            """Admin endpoint for the fleet's rolling rollout: swap this
            replica to a named checkpoint step, synchronously. 200 when the
            step is serving; 409 when the swap failed and the replica kept
            its old weights (degraded-version, still healthy — the
            coordinator records the failure and moves on)."""
            mgr = server.hotswap
            if mgr is None:
                self._json(404, {
                    "error": "hot-swap not enabled (no --checkpoint-dir)",
                })
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                msg = json.loads(self.rfile.read(n) or b"{}")
                step = int(msg["step"])
            except (json.JSONDecodeError, KeyError, ValueError,
                    TypeError) as e:
                self._json(400, {"error": f"bad swap request: {e}"})
                return
            out = mgr.swap_to(step)
            self._json(200 if out.get("ok") else 409, out)

    httpd = ThreadingHTTPServer((host, port), Handler)
    httpd.active_streams = 0
    httpd.streams_lock = threading.Lock()
    return httpd


def wait_until(predicate, timeout: float, poll_s: float = 0.005) -> bool:
    """Poll ``predicate`` until true or ``timeout``; serving tests' one
    shared clock helper (kept here so tests and bench don't re-invent it)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(poll_s)
    return bool(predicate())
