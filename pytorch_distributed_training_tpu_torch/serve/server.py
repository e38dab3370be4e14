"""Threaded serving front-end over the decode engine (counterpart: the JAX
package's ``serve/server.py``; the stdio transport).

``InferenceServer`` owns the request queue, the engine and the serve-loop
thread (the engine is single-threaded by contract; front-end threads only
touch the queue). ``serve_stdio`` is JSONL in / JSONL out with the JAX
package's events: ``token`` per generated token, then one ``done`` per
request (``error`` for a rejected line or request).

Shutdown: ``close(drain=True)`` stops admissions and runs the engine until
in-flight work completes; ``close(drain=False)`` cancels it. Either way
every waiter's ``done`` event fires. The HTTP front-end, health endpoint
and hot-swap are not ported yet.

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
import threading
from typing import Optional

import numpy as np

from pytorch_distributed_training_tpu_torch.serve.engine import (
    DecodeEngine,
    EngineConfig,
)
from pytorch_distributed_training_tpu_torch.serve.queue import (
    BackpressureError,
    GenRequest,
    RequestQueue,
)
from pytorch_distributed_training_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_IDLE_WAIT_S = 0.02


class InferenceServer:
    """Queue + engine + serve-loop thread, one object."""

    def __init__(self, model, config: EngineConfig, *, device="cuda",
                 queue_depth: int = 16,
                 default_deadline_s: Optional[float] = None, shard=None,
                 weights_step: Optional[int] = None, draft_model=None):
        self.queue = RequestQueue(
            max_depth=queue_depth,
            prompt_buckets=config.prompt_buckets,
            max_new_tokens=config.max_new_tokens,
        )
        self.engine = DecodeEngine(model, config, self.queue, device=device,
                                   shard=shard, weights_step=weights_step,
                                   draft_model=draft_model)
        self.default_deadline_s = default_deadline_s
        self._ids = itertools.count()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._drain_mode = threading.Event()
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
            self._loop_failed.set()
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
        first; ``drain=False`` cancels it. Idempotent."""
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

    # ------------------------------------------------------------ submission

    def submit(self, prompt_ids, *, max_new_tokens: int,
               temperature: float = 0.0, top_k: int = 0,
               eot_id: Optional[int] = None, seed: int = 0,
               deadline_s: Optional[float] = None,
               tier: str = "interactive", tenant: Optional[str] = None,
               stream=None, on_finish=None,
               request_id: Optional[str] = None,
               spec: Optional[bool] = None) -> GenRequest:
        """Enqueue one request (any thread). Raises ``BackpressureError``
        when the queue is full; the request's ``done`` event fires at every
        terminal state. ``tier``: its SLO lane (``interactive``,
        ``batch``); ``tenant``: who it is charged to (None: nobody);
        ``spec`` opts it in or out of speculative decoding (None: the
        engine's default)."""
        if deadline_s is None:
            deadline_s = self.default_deadline_s
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
        )
        return self.queue.submit(req)

    def stats(self) -> dict:
        return self.engine.stats()

    def loop_dead(self) -> bool:
        """True when the serve loop can no longer finish requests."""
        if self._loop_failed.is_set():
            return True
        thread = self._thread
        return thread is not None and not thread.is_alive()


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

