"""Serving entry point: continuous-batching LM inference over stdio JSONL
or HTTP (counterpart: the JAX package's ``cli/serve_lm.py``).

    echo '{"prompt": "The quick brown", "max_new_tokens": 16}' | \\
    python -m pytorch_distributed_training_tpu_torch.cli.serve_lm \\
        --model gpt2-medium --num-slots 8

    # HTTP: POST /generate streams JSONL token events; GET /healthz,
    # /stats, /debug/flight; POST /swap with --checkpoint-dir
    python -m pytorch_distributed_training_tpu_torch.cli.serve_lm \\
        --model gpt2-medium --checkpoint-dir /ckpts/run1 --http-port 8000 \\
        --warmup --hotswap-poll-s 1 --metrics-dir /tmp/serve_metrics

Runs on the GPU (``--device cuda``, the default; it raises when no GPU is
visible and never carries on quietly on the CPU) or on the CPU with
``--device cpu``, where every kernel takes its plain PyTorch version.
Engine knobs as in the JAX package: ``--num-slots`` fixed decode slots,
``--prompt-buckets`` prefill lengths, ``--max-new-tokens-cap`` bounds the
KV cache (largest bucket + cap), ``--page-size``/``--num-pages`` size the
paged KV pool, ``--queue-depth`` backpressure, ``--deadline-s`` default
deadline. Serving options: ``--spec-k`` speculative decoding (n-gram
drafts, or a draft model's with ``--draft-checkpoint DIR --draft-model
PRESET``, loaded as the base model is), ``--prefill-chunk`` and
``--prefill-concurrency`` chunked prefill, ``--prefix-cache`` the
shared-KV prefix cache (``--tenant-page-quota F``: a tenant's private
pages capped at a fraction of the pool; request lines carry ``tenant``
and ``tier``), ``--weights-dtype int8`` weight-only int8 projections
(quantized after loading), ``--kv-dtype int8`` int8 KV pools,
``--kv-layout dense`` the dense per-slot cache and ``--sampling host``
host-side sampling (the plain baselines). Weights: ``--checkpoint-dir`` (a trainer checkpoint, the
newest verified step; the engine reports it as ``stats()["weights_step"]``),
``--hf-checkpoint`` or random from ``--seed`` (``cli/generate_lm.py``'s
``load_model_and_params``). Events go to stdout, logs to stderr.

Service knobs, as in the JAX package: ``--warmup`` runs every serving
shape once before the first request; ``--interactive-deadline-s`` and
``--batch-deadline-s`` are the tiers' deadlines (else ``--deadline-s``);
``--brownout-*`` the overload ladder (off at ``--brownout-high 0``);
``--metrics-dir`` the JSONL telemetry stream (``serve_meta``, per-request
``serve_request`` records and spans, ``slo_burn``, flight dumps, a
``serve_summary`` at exit; ``scripts/summarize_metrics.py`` reads it),
``--flight-capacity`` the flight recorder's ring, ``--slo-*`` the burn
monitor, ``--replica-name`` the name on spans and flight records,
``--guards`` the runtime guards' and the lock registry's mode (strict by
default, as JAX's: a recompile, an implicit transfer or a lock-order
inversion fails the serve loop; ``stats()`` carries ``guard_recompiles``
and ``guard_implicit_transfers``; a ``lock_summary`` record at exit, and
every ``--lock-summary-s`` seconds). With ``--http-port`` the server answers HTTP
(``serve/server.py``); SIGTERM drains it (admit nothing, finish
in-flight streams for up to
``--drain-timeout-s``, dump the flight recorder) and exits 75;
``/healthz`` says ``unhealthy`` past ``--stall-timeout-s`` without a
tick. With ``--checkpoint-dir``, ``POST /swap`` swaps to a named step and
``--hotswap-poll-s N`` watches the directory for newly sealed steps
(verified at ``--hotswap-verify``), swapped in between ticks with no
restart (``serve/hotswap.py``).

``--tp N`` serves one replica over N processes, one a card, launched by
``torch.distributed.run`` (NCCL on cards, gloo with ``--device cpu``)::

    python -m torch.distributed.run --nproc-per-node 2 \\
        -m pytorch_distributed_training_tpu_torch.cli.serve_lm \\
        --model gpt2-medium --tp 2 < requests.jsonl

``--tp`` must equal the world size. Every rank builds the whole model from the
same ``--seed`` (or loads the same checkpoint) and cuts its slice; rank 0, the leader, reads the requests on stdin and
writes the events, and the other ranks run their slice of every device
call (``serve/tp_worker.py``). Every rank exits 0 at EOF. A follower
ignores SIGTERM: the drain is the leader's (it finishes in-flight work,
sends the stop message and exits 75), and the fleet's ``RankGroup``
sends the signal to every rank.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional


def build_parser() -> argparse.ArgumentParser:
    from pytorch_distributed_training_tpu_torch.cli.generate_lm import (
        add_model_args,
    )

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_model_args(p)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the engine runs (cuda raises when no GPU is "
                        "visible)")
    p.add_argument("--num-slots", type=int, default=4,
                   help="fixed decode slots (concurrent in-flight requests)")
    p.add_argument("--prompt-buckets", default="16,32,64,128",
                   help="comma-separated prompt-length buckets; prompts pad "
                        "up to the smallest that fits")
    p.add_argument("--max-new-tokens-cap", type=int, default=64,
                   help="per-request max_new_tokens ceiling; KV cache length "
                        "= largest bucket + this cap")
    p.add_argument("--queue-depth", type=int, default=16,
                   help="admission-queue depth; submissions beyond it are "
                        "rejected with a backpressure error")
    p.add_argument("--kv-layout", default="paged",
                   choices=("paged", "dense"),
                   help="KV-cache layout: paged (block-table pages, "
                        "page-budget admission) or dense (one [slots, "
                        "cache_len] buffer, the plain baseline)")
    p.add_argument("--page-size", type=int, default=16,
                   help="tokens per KV page")
    p.add_argument("--num-pages", type=int, default=0,
                   help="total KV pages incl. the reserved null page (0 = "
                        "auto-size so every slot fits a worst-case request)")
    p.add_argument("--sampling", default="device",
                   choices=("device", "host"),
                   help="token selection: device ([slots] token ids to "
                        "the host a tick) or host (float32 logits to the "
                        "host, sampled in numpy: the reference path)")
    p.add_argument("--spec-k", type=int, default=0,
                   help="speculative decoding: draft tokens proposed per "
                        "slot per tick (0 = off); each verify dispatch "
                        "scores k+1 positions and commits every accepted "
                        "one — same token stream, fewer dispatches; drafts "
                        "come from the n-gram (prompt-lookup) drafter, or "
                        "from --draft-checkpoint's model")
    p.add_argument("--draft-checkpoint", default=None,
                   help="trainer checkpoint dir of a small DRAFT model that "
                        "proposes the speculative tokens (its newest "
                        "verified step); without it --spec-k uses the "
                        "n-gram drafter")
    p.add_argument("--draft-model", default="gpt2-tiny",
                   help="model preset of --draft-checkpoint (its vocab "
                        "must match the base model's)")
    p.add_argument("--prefill-chunk", type=int, default=0,
                   help="chunked prefill: stream prompts into the paged KV "
                        "cache this many tokens per tick (0 = one prefill "
                        "per bucket); long prompts stop monopolising the "
                        "tick loop")
    p.add_argument("--prefill-concurrency", type=int, default=1,
                   help="slots streaming a chunked prompt at once; further "
                        "admissions wait a tick (a hold, not page "
                        "exhaustion)")
    p.add_argument("--prefix-cache", action="store_true",
                   help="shared-KV prefix cache: finished prompts' pages "
                        "are indexed in a token-keyed trie and a matching "
                        "prompt prefix is served from the cache (refcounted "
                        "pages, copy-on-write at the divergence point) — "
                        "only the tail is prefilled, streams identical to "
                        "cold prefill")
    p.add_argument("--tenant-page-quota", type=float, default=0.0,
                   help="a tenant's PRIVATE-page ceiling as a fraction of "
                        "the page pool (0 = none): a request of a tenant "
                        "whose unshared pages would pass it waits at "
                        "admission; shared prefix pages are free. Requires "
                        "--prefix-cache")
    p.add_argument("--weights-dtype", default="float32",
                   choices=("float32", "int8"),
                   help="serving weight precision: int8 quantizes every "
                        "attention/MLP projection at load (per-channel fp32 "
                        "scales, dequantized per call; activations and "
                        "logits unchanged) at ~0.5x resident projection "
                        "bytes of bf16")
    p.add_argument("--kv-dtype", default="float32",
                   choices=("float32", "int8"),
                   help="paged KV precision: int8 pools + fp32 "
                        "per-page-per-head scale pools, quantized on write "
                        "and dequantized in the paged kernels ((head_dim + "
                        "4) bytes a head and token; the page count and "
                        "admission are unchanged)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor parallelism: shard THIS replica's engine "
                        "over N processes, one a card (attention heads + "
                        "MLP hidden on a model-axis mesh, paged KV pools "
                        "split on the head dim; page counts are tp=1's). "
                        "Requires a model whose num_heads/intermediate_size "
                        "divide by N and a launch of N processes "
                        "(torch.distributed.run --nproc-per-node N)")
    p.add_argument("--warmup", action="store_true",
                   help="run every prefill bucket (or the chunk), a decode "
                        "and a verify once before serving: kernel builds "
                        "and first launches leave the first request")
    p.add_argument("--lock-summary-s", type=float, default=0.0,
                   help="emit the lock_summary telemetry record every this "
                        "many seconds DURING the run (0 = shutdown-only; a "
                        "wedged process never reaches shutdown, so set this "
                        "on long-lived replicas)")
    p.add_argument("--deadline-s", type=float, default=0.0,
                   help="default per-request deadline (0 = none)")
    p.add_argument("--interactive-deadline-s", type=float, default=0.0,
                   help="SLO deadline for tier=interactive requests "
                        "(0 = fall back to --deadline-s)")
    p.add_argument("--batch-deadline-s", type=float, default=0.0,
                   help="SLO deadline for tier=batch requests "
                        "(0 = fall back to --deadline-s)")
    p.add_argument("--brownout-high", type=float, default=0.0,
                   help="enable the brownout ladder: escalate one level "
                        "(shed batch -> clamp max_new -> fail-fast "
                        "interactive) when queue pressure stays above this "
                        "fraction of capacity (0 = brownout off)")
    p.add_argument("--brownout-low", type=float, default=0.3,
                   help="de-escalate one level when pressure stays below "
                        "this fraction (hysteresis band with "
                        "--brownout-high)")
    p.add_argument("--brownout-clamp", type=int, default=16,
                   help="max_new_tokens cap applied at brownout level 2+")
    p.add_argument("--brownout-escalate-hold-s", type=float, default=0.5,
                   help="pressure must stay above --brownout-high this long "
                        "before each escalation")
    p.add_argument("--brownout-deescalate-hold-s", type=float, default=1.0,
                   help="pressure must stay below --brownout-low this long "
                        "before each recovery step")
    p.add_argument("--http-port", type=int, default=0,
                   help="serve HTTP on <host>:<port> (0 = stdin/JSONL mode)")
    p.add_argument("--http-host", default="127.0.0.1",
                   help="HTTP bind host")
    p.add_argument("--drain-timeout-s", type=float, default=10.0,
                   help="SIGTERM grace window: stop admitting, finish "
                        "in-flight requests up to this many seconds, then "
                        "exit 75 (resumable)")
    p.add_argument("--stall-timeout-s", type=float, default=10.0,
                   help="/healthz reports 'unhealthy' when the serve loop's "
                        "tick heartbeat is older than this")
    p.add_argument("--hotswap-poll-s", type=float, default=0.0,
                   help="poll --checkpoint-dir every this many seconds and "
                        "hot-swap newly published, manifest-verified steps "
                        "into the running engine with no restart (0 = no "
                        "polling; POST /swap still works with a checkpoint "
                        "dir)")
    p.add_argument("--hotswap-verify", default="digest",
                   choices=("size", "digest"),
                   help="integrity level a step must pass before a live "
                        "swap admits it (digest re-hashes every file)")
    p.add_argument("--metrics-dir", default=None,
                   help="stream serve telemetry (JSONL) under this directory")
    p.add_argument("--flight-capacity", type=int, default=256,
                   help="engine flight-recorder ring size: last N tick "
                        "summaries dumped as a flight_dump record on "
                        "watchdog stall, fatal tick, SIGTERM drain and "
                        "GET /debug/flight")
    p.add_argument("--slo-windows", default="300,3600",
                   help="comma-separated burn-rate window lengths in "
                        "seconds (telemetry/slo.py slo_burn records)")
    p.add_argument("--slo-emit-s", type=float, default=5.0,
                   help="min seconds between slo_burn records")
    p.add_argument("--slo-burn-high", type=float, default=0.0,
                   help="brownout coupling: burn rate at/above this reads "
                        "as high-watermark pressure on the overload ladder "
                        "(0 = off)")
    p.add_argument("--replica-name", default=None,
                   help="replica identity stamped on spans and flight "
                        "records")
    p.add_argument("--guards", default=None,
                   choices=("off", "record", "strict"),
                   help="runtime correctness guards (analysis/guards.py) "
                        "AND lock-discipline mode (analysis/concurrency): "
                        "strict (default) fails the serve loop on "
                        "recompile/implicit-transfer/lock-order "
                        "violations; pass --guards record to only emit "
                        "telemetry (the rollout opt-out), off to disable; "
                        "PDT_TPU_GUARDS overrides the default")
    return p


def _guard_mode(args) -> str:
    """``--guards``, else ``PDT_TPU_GUARDS``, else strict (JAX's serve
    default: violations fail the loop)."""
    from pytorch_distributed_training_tpu_torch.analysis.guards import (
        guard_mode_from_env,
    )

    return args.guards or guard_mode_from_env(default="strict")


def _lock_discipline(args) -> None:
    """Set the lock registry's mode from ``--guards`` (``_guard_mode``),
    before any server or engine lock is made, so ``off`` skips the
    instrumentation entirely."""
    from pytorch_distributed_training_tpu_torch.analysis.concurrency import (
        get_lock_registry,
    )

    get_lock_registry().mode = _guard_mode(args)


def _guards(args, registry=None):
    """The ``GuardSet`` of ``--guards`` (``_guard_mode``) over
    ``registry``, for the engine (or a follower's slice)."""
    from pytorch_distributed_training_tpu_torch.analysis.guards import (
        GuardSet,
    )

    return GuardSet(mode=_guard_mode(args), registry=registry)


def engine_config(args):
    """The ``EngineConfig`` of parsed ``args`` (the leader's and every
    follower's)."""
    from pytorch_distributed_training_tpu_torch.serve import EngineConfig

    return EngineConfig(
        num_slots=args.num_slots,
        prompt_buckets=tuple(
            int(b) for b in args.prompt_buckets.split(",") if b.strip()
        ),
        max_new_tokens=args.max_new_tokens_cap,
        kv_layout=args.kv_layout,
        page_size=args.page_size,
        num_pages=args.num_pages,
        sampling=args.sampling,
        spec_k=args.spec_k,
        spec_draft=draft_lane(args),
        prefill_chunk=args.prefill_chunk,
        prefill_concurrency=args.prefill_concurrency,
        prefix_cache=args.prefix_cache,
        tenant_page_quota=args.tenant_page_quota,
        tp=args.tp,
        weights_dtype=args.weights_dtype,
        kv_dtype=args.kv_dtype,
        warmup=args.warmup,
        flight_capacity=args.flight_capacity,
    )


def draft_lane(args) -> str:
    """The draft lane ``args`` ask for: "model" with ``--spec-k`` and
    ``--draft-checkpoint``, else "ngram"."""
    return "model" if args.spec_k > 0 and args.draft_checkpoint else "ngram"


def _draft(args, tok):
    """The draft lane's model (None for the n-gram lane): ``--draft-model``
    loaded from ``--draft-checkpoint`` through ``load_model_and_params`` on
    a copy of ``args``, so the boot step, trunk layout and vocabulary
    checks are the base model's (JAX ``cli/serve_lm``)."""
    from pytorch_distributed_training_tpu_torch.cli.generate_lm import (
        load_model_and_params,
    )

    if draft_lane(args) != "model":
        return None
    draft_args = argparse.Namespace(**{
        **vars(args), "model": args.draft_model,
        "checkpoint_dir": args.draft_checkpoint, "hf_checkpoint": None})
    return load_model_and_params(draft_args, tok)[0]


def _model(args):
    """``(model, tokenizer, ckpt_step, draft)`` of parsed ``args``: the
    model on the CPU, float32, from ``--checkpoint-dir``,
    ``--hf-checkpoint`` or ``--seed`` (the same on every rank;
    ``cli/generate_lm.py``), and the draft lane's model or None."""
    import torch

    from pytorch_distributed_training_tpu_torch.cli.generate_lm import (
        build_tokenizer,
        load_model_and_params,
    )

    # the float32 logits product must stay float32 (no TF32 rounding)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tok = build_tokenizer(args)
    model, step = load_model_and_params(args, tok)
    return model, tok, step, _draft(args, tok)


def _telemetry(args):
    """The registry the server records into, with ``--metrics-dir``'s sink
    attached and its ``serve_meta`` header written (JAX's keys); the SLO
    monitor; the brownout controller (None at ``--brownout-high 0``)."""
    from pytorch_distributed_training_tpu_torch.serve.queue import (
        BrownoutController,
    )
    from pytorch_distributed_training_tpu_torch.telemetry.registry import (
        get_registry,
    )
    from pytorch_distributed_training_tpu_torch.telemetry.slo import (
        BurnRateMonitor,
        SloConfig,
    )

    registry = get_registry()
    if args.metrics_dir:
        from pytorch_distributed_training_tpu_torch.telemetry.sink import (
            JsonlSink,
        )

        sink = JsonlSink(args.metrics_dir)
        registry.attach_sink(sink)
        sink.emit({
            "record": "serve_meta",
            "model": args.model,
            "num_slots": args.num_slots,
            "prompt_buckets": args.prompt_buckets,
            "max_new_tokens_cap": args.max_new_tokens_cap,
            "queue_depth": args.queue_depth,
            "kv_layout": args.kv_layout,
            "page_size": args.page_size,
            "num_pages": args.num_pages,
            "sampling": args.sampling,
            "spec_k": args.spec_k,
            "spec_draft": draft_lane(args) if args.spec_k > 0 else None,
            "prefill_chunk": args.prefill_chunk,
            "tp": args.tp,
            "weights_dtype": args.weights_dtype,
            "kv_dtype": args.kv_dtype,
            "prefix_cache": args.prefix_cache,
            "tenant_page_quota": args.tenant_page_quota,
        })
    # the burn monitor is always on (one throttled slo_burn record an
    # interval); its brownout coupling is opt-in
    slo = BurnRateMonitor(
        SloConfig(windows_s=tuple(float(w) for w in
                                  args.slo_windows.split(",") if w.strip()),
                  emit_interval_s=args.slo_emit_s),
        registry=registry)
    brownout = None
    if args.brownout_high > 0:
        brownout = BrownoutController(
            high_watermark=args.brownout_high,
            low_watermark=args.brownout_low,
            escalate_hold_s=args.brownout_escalate_hold_s,
            deescalate_hold_s=args.brownout_deescalate_hold_s,
            clamp_max_new=args.brownout_clamp, registry=registry,
            slo_monitor=slo if args.slo_burn_high > 0 else None,
            slo_burn_high=args.slo_burn_high)
    return registry, slo, brownout


def build_server(args, *, device=None, shard=None):
    """``(server, tokenizer)`` for parsed ``args``: the model on its device
    behind an unstarted ``InferenceServer`` with the telemetry, SLO,
    brownout and deadline flags wired (``device``: ``--device``'s when
    None; ``shard``: the model axis under ``--tp``, this rank the
    leader)."""
    from pytorch_distributed_training_tpu_torch.serve import InferenceServer
    from pytorch_distributed_training_tpu_torch.utils.device import (
        resolve_device,
    )

    if device is None:
        device = resolve_device(args.device)  # before any weights are built
    model, tok, step, draft = _model(args)
    registry, slo, brownout = _telemetry(args)
    tier_deadlines = {}
    if args.interactive_deadline_s > 0:
        tier_deadlines["interactive"] = args.interactive_deadline_s
    if args.batch_deadline_s > 0:
        tier_deadlines["batch"] = args.batch_deadline_s
    # the engine serves its own cast copy of the model (and of the draft)
    server = InferenceServer(
        model, engine_config(args), device=device,
        queue_depth=args.queue_depth,
        default_deadline_s=args.deadline_s or None,
        tier_deadlines=tier_deadlines or None, brownout=brownout,
        registry=registry, stall_timeout_s=args.stall_timeout_s,
        shard=shard, weights_step=step, draft_model=draft, slo=slo,
        replica_name=args.replica_name, guards=_guards(args, registry),
    )
    return server, tok


#: the exit status of a replica whose ``--http-port`` was taken: not a
#: crash, a supervisor retries it on a fresh port
PORT_IN_USE_EXIT_CODE = 76


def _serve_http(args, server, tok) -> Optional[int]:
    """Serve HTTP until SIGTERM (or an interrupt); the signal's number
    when one ended it. SIGTERM only flags; a drain thread stops
    admissions, finishes in-flight work for up to ``--drain-timeout-s``,
    dumps the flight recorder, lets the streams flush and stops the
    server, while this thread goes on answering (``/healthz`` says
    ``draining`` throughout)."""
    import errno
    import signal
    import threading
    import time

    from pytorch_distributed_training_tpu_torch.serve import (
        make_http_server,
    )
    from pytorch_distributed_training_tpu_torch.utils.logging import log0

    try:
        httpd = make_http_server(server, tok, host=args.http_host,
                                 port=args.http_port)
    except OSError as e:
        if e.errno != errno.EADDRINUSE:
            raise
        log0(f"port {args.http_port} already in use; exiting "
             f"{PORT_IN_USE_EXIT_CODE} for a fresh-port respawn")
        server.close(drain=False)
        sys.exit(PORT_IN_USE_EXIT_CODE)
    log0(f"serving on http://{args.http_host}:{httpd.server_address[1]} "
         f"(POST /generate, GET /healthz, GET /stats)")
    drain_requested = threading.Event()
    got = {"signal": None}

    main = threading.main_thread()

    def drain() -> None:
        # set at SIGTERM, or by the main thread when serving ends
        while not drain_requested.wait(1.0):
            if not main.is_alive():
                return
        t0 = time.monotonic()
        log0(f"SIGTERM: draining (finish in-flight, admit nothing, "
             f"deadline {args.drain_timeout_s:.1f}s)")
        server.close(drain=True, timeout=args.drain_timeout_s)
        # what the engine was doing when the preemption landed
        server.engine.flight.dump("sigterm_drain")
        deadline = time.monotonic() + 2.0
        while httpd.active_streams and time.monotonic() < deadline:
            time.sleep(0.01)
        server.registry.emit({"record": "preemption", "scope": "serve",
                              "drain_s": time.monotonic() - t0})
        httpd.shutdown()

    drainer = threading.Thread(target=drain, name="serve-drain",
                               daemon=True)
    drainer.start()

    def on_term(signum, frame):
        got["signal"] = signum
        drain_requested.set()

    signal.signal(signal.SIGTERM, on_term)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        drain_requested.set()
        httpd.shutdown()
        drainer.join(args.drain_timeout_s + 5.0)
        httpd.server_close()
    return got["signal"]


def _serve(args, server, tok, in_stream, out_stream) -> dict:
    """Serve stdio until EOF, or HTTP until SIGTERM, with the hot-swap
    manager attached under ``--checkpoint-dir``; the engine's final stats
    (``Preempted``, exit 75, after a SIGTERM drain)."""
    from pytorch_distributed_training_tpu_torch.analysis.concurrency import (
        get_lock_registry,
        start_periodic_summary,
    )
    from pytorch_distributed_training_tpu_torch.faults.preemption import (
        Preempted,
    )
    from pytorch_distributed_training_tpu_torch.serve import serve_stdio
    from pytorch_distributed_training_tpu_torch.utils.logging import log0

    server.start()
    signum = None
    # in-run lock_summary cadence: a wedged replica still leaves its
    # contention/hold stats in the stream (the exit's record never comes)
    lock_summary = (start_periodic_summary(args.lock_summary_s,
                                           registry=server.registry)
                    if args.lock_summary_s > 0 else None)
    try:
        if args.checkpoint_dir and not args.hf_checkpoint:
            from pytorch_distributed_training_tpu_torch.serve.hotswap import (
                HotSwapManager,
            )

            server.attach_hotswap(HotSwapManager(
                server, args.checkpoint_dir,
                poll_interval_s=args.hotswap_poll_s,
                verify_level=args.hotswap_verify, registry=server.registry,
                start_step=server.engine.weights_step).start())
        if args.http_port:
            signum = _serve_http(args, server, tok)
        else:
            served = serve_stdio(
                server, tok,
                in_stream if in_stream is not None else sys.stdin,
                out_stream if out_stream is not None else sys.stdout,
            )
            log0(f"stdio stream closed after {served} requests")
    finally:
        if lock_summary is not None:
            lock_summary.stop()
        server.close(drain=True)
        stats = server.stats()
        sink = server.registry.sink
        if sink is not None:
            sink.emit({"record": "serve_summary", **stats})
            # the run's per-lock contention/hold/wait accounting
            sink.emit(get_lock_registry().summary_record())
            sink.flush(fsync=True)
    if signum is not None:
        raise Preempted(signum)
    return stats


def _follow_drain() -> None:
    """A follower's SIGTERM: ignored, so the leader's drain can still run
    its last calls here; the leader's stop message ends the follower."""
    import signal
    import threading

    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, signal.SIG_IGN)


def _main_tp(args, in_stream, out_stream) -> dict:
    """``--tp N``: join the launcher's process group, one model group of N
    ranks; rank 0 serves stdio as the leader, the others follow until its
    stop message. Rank 0 returns the engine's stats, a follower its own."""
    from pytorch_distributed_training_tpu_torch.comms.bootstrap import (
        initialize,
        shutdown,
    )
    from pytorch_distributed_training_tpu_torch.comms.collectives import (
        broadcast_call,
    )
    from pytorch_distributed_training_tpu_torch.comms.mesh import build_mesh
    from pytorch_distributed_training_tpu_torch.serve import run_follower
    from pytorch_distributed_training_tpu_torch.serve.engine import CALL_STOP
    from pytorch_distributed_training_tpu_torch.utils.config import (
        MeshConfig,
    )
    from pytorch_distributed_training_tpu_torch.utils.device import (
        resolve_device,
    )

    _lock_discipline(args)
    info = initialize(resolve_device(args.device))
    try:
        if info.world_size != args.tp:
            raise ValueError(
                f"--tp {args.tp} must equal the world size "
                f"{info.world_size} (launch --nproc-per-node {args.tp})")
        shard = build_mesh(MeshConfig(data=1, model=args.tp),
                           rank=info.rank,
                           world_size=info.world_size).shard("model")
        if shard.index:
            _follow_drain()
            model, _, _, draft = _model(args)
            return run_follower(model, engine_config(args),
                                device=info.device, shard=shard,
                                draft_model=draft, guards=_guards(args))
        try:
            server, tok = build_server(args, device=info.device, shard=shard)
        except BaseException:
            broadcast_call(shard, CALL_STOP)  # the followers wait on a call
            raise
        return _serve(args, server, tok, in_stream, out_stream)
    finally:
        shutdown()


def main(argv=None, in_stream=None, out_stream=None) -> dict:
    """Serve until EOF on the input stream; returns the engine's final
    stats dict (under ``--tp``, a follower's own stats on ranks above
    0)."""
    args = build_parser().parse_args(argv)
    if args.tp > 1:
        return _main_tp(args, in_stream, out_stream)
    _lock_discipline(args)
    server, tok = build_server(args)
    return _serve(args, server, tok, in_stream, out_stream)


if __name__ == "__main__":
    main()
