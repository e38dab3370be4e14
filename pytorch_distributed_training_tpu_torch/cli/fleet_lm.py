"""Fleet serving entry point: router + N supervised replica processes
(counterpart: the JAX package's ``cli/fleet_lm.py``, with its flags and
defaults, plus ``--device``).

Fronts ``cli/serve_lm.py`` replicas (one subprocess + HTTP port each) with
the health-checked router (serve/router.py) and the replica supervisor
(serve/fleet.py). One command turns a checkpoint into a resilient pool:

    python -m pytorch_distributed_training_tpu_torch.cli.fleet_lm \
        --replicas 2 --router-port 8000 \
        --model gpt2-medium --checkpoint-dir /ckpts/run1 \
        --num-slots 8 --metrics-dir /tmp/fleet_metrics

Every replica runs on ``--device`` (``cuda``, the default, or ``cpu``);
replicas of one host share its card. Clients talk to the router exactly
as they would to a single replica (``POST /generate`` streams JSONL
events; ``GET /healthz``/``/stats``) — but a crashed replica is retried
away (if nothing streamed yet) or surfaced as an explicit retryable error
(if it died mid-stream), a hung replica trips a circuit breaker and
recovers through a half-open probe, a SIGTERM'd replica drains and exits
75 (respawned with no restart burned), and a fully-down pool answers 503
with ``Retry-After`` instead of hanging. ``PDT_TPU_FAULT=replica_crash:5@1``
etc. target individual replicas for chaos drills (see faults/inject.py).

With ``--hotswap-poll-s N`` (and a ``--checkpoint-dir``) newly published,
manifest-verified checkpoint steps roll across the pool one replica at a
time with no restart — a replica whose swap fails keeps its old weights
(the router reports the resulting version skew) and a poisoned step is
blocklisted, never retried (serve/hotswap.py). ``--max-replicas N`` turns
on the autoscaler (serve/autoscale.py). ``--guards`` sets the lock
registry's mode here and in every replica (``analysis/concurrency``), and
the replicas' runtime guards (``analysis/guards.py``).

SIGTERM/SIGINT to THIS process drains the whole fleet: every replica
stops admitting, finishes in-flight work and exits 75; the router goes
down last. The process imports no torch.
"""

from __future__ import annotations

import argparse
import signal
import threading


def build_parser() -> argparse.ArgumentParser:
    from pytorch_distributed_training_tpu_torch.cli.generate_lm import (
        add_model_args,
    )

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_model_args(p)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="every replica's device (forwarded as serve_lm "
                        "--device); replicas of one host share its card")
    p.add_argument("--replicas", type=int, default=2,
                   help="replica subprocess count")
    p.add_argument("--router-port", type=int, default=8000,
                   help="router HTTP port (0 picks a free one)")
    p.add_argument("--num-slots", type=int, default=4)
    p.add_argument("--prompt-buckets", default="16,32,64,128")
    p.add_argument("--max-new-tokens-cap", type=int, default=64)
    p.add_argument("--queue-depth", type=int, default=16)
    p.add_argument("--deadline-s", type=float, default=0.0)
    p.add_argument("--kv-layout", default="paged", choices=("paged", "dense"),
                   help="replica KV cache layout (see serve_lm)")
    p.add_argument("--page-size", type=int, default=16,
                   help="tokens per KV page when --kv-layout=paged")
    p.add_argument("--num-pages", type=int, default=0,
                   help="KV page pool size per replica (0 = auto-size)")
    p.add_argument("--sampling", default="device",
                   choices=("device", "host"),
                   help="replica sampling mode (see serve_lm)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel width per replica: each replica "
                        "is this many serve_lm ranks the fleet spawns, its "
                        "exit status the leader's (forwarded as serve_lm "
                        "--tp; one card a rank, gloo with --device cpu)")
    p.add_argument("--guards", default=None,
                   choices=("off", "record", "strict"),
                   help="runtime guard + lock-discipline mode, forwarded "
                        "to every replica and applied to the coordinator's "
                        "own locks: strict (default) fails on violations; "
                        "--guards record is the telemetry-only opt-out; "
                        "PDT_TPU_GUARDS overrides the default")
    p.add_argument("--lock-summary-s", type=float, default=0.0,
                   help="emit an in-run lock_summary record every this many "
                        "seconds from the coordinator AND every replica "
                        "(0 = final summary only)")
    p.add_argument("--max-restarts", type=int, default=2,
                   help="per-replica crash-restart budget (exit 75 drains "
                        "never burn one)")
    p.add_argument("--restart-window-s", type=float, default=0.0,
                   help="sliding restart budget window (0 = lifetime)")
    p.add_argument("--drain-timeout-s", type=float, default=10.0,
                   help="per-replica SIGTERM drain deadline")
    p.add_argument("--hedge-s", type=float, default=0.0,
                   help="tail-latency hedging: duplicate a request on a "
                        "second replica when the first byte takes longer "
                        "than this (0 = off)")
    p.add_argument("--request-retries", type=int, default=2,
                   help="max failover attempts on other replicas for "
                        "not-yet-streamed requests")
    p.add_argument("--metrics-dir", default=None,
                   help="fleet/router telemetry JSONL dir; replicas write "
                        "their own streams under <dir>/replica-<i>")
    p.add_argument("--hotswap-poll-s", type=float, default=0.0,
                   help="poll --checkpoint-dir every this many seconds and "
                        "roll newly published, manifest-verified steps "
                        "across the pool one replica at a time (live "
                        "weight reload, no restart; 0 = off)")
    p.add_argument("--hotswap-verify", default="digest",
                   choices=("size", "digest"),
                   help="integrity level a step must pass before the "
                        "rolling swap admits it")
    p.add_argument("--max-replicas", type=int, default=0,
                   help="enable queue-driven autoscaling up to this pool "
                        "size (0 = static pool); scale-up spawns through "
                        "the normal machinery, scale-down drains via "
                        "SIGTERM/exit-75 so no in-flight request dies")
    p.add_argument("--min-replicas", type=int, default=1,
                   help="autoscaler floor (never drains below this)")
    p.add_argument("--autoscale-up-depth", type=float, default=6.0,
                   help="scale up when mean queue depth per available "
                        "replica holds at/above this")
    p.add_argument("--autoscale-down-depth", type=float, default=1.0,
                   help="scale down when mean queue depth per available "
                        "replica holds at/below this")
    p.add_argument("--autoscale-up-hold-s", type=float, default=1.0,
                   help="scale-up signal must persist this long")
    p.add_argument("--autoscale-down-hold-s", type=float, default=5.0,
                   help="idle signal must persist this long before "
                        "retiring capacity")
    p.add_argument("--autoscale-up-cooldown-s", type=float, default=5.0,
                   help="no further scaling for this long after a "
                        "scale-up")
    p.add_argument("--autoscale-down-cooldown-s", type=float, default=10.0,
                   help="no further scaling for this long after a "
                        "scale-down")
    p.add_argument("--autoscale-poll-s", type=float, default=0.5,
                   help="autoscaler evaluation cadence")
    p.add_argument("--interactive-deadline-s", type=float, default=0.0,
                   help="per-tier SLO deadline forwarded to every replica")
    p.add_argument("--batch-deadline-s", type=float, default=0.0,
                   help="per-tier SLO deadline forwarded to every replica")
    p.add_argument("--brownout-high", type=float, default=0.0,
                   help="forward the brownout ladder to every replica: "
                        "escalate when queue pressure holds above this "
                        "fraction (0 = off; see serve_lm)")
    p.add_argument("--brownout-low", type=float, default=0.3,
                   help="brownout de-escalation watermark (see serve_lm)")
    p.add_argument("--brownout-clamp", type=int, default=16,
                   help="brownout level-2 max_new_tokens cap (see serve_lm)")
    p.add_argument("--slo-burn-high", type=float, default=0.0,
                   help="couple the autoscaler to the router-side SLO "
                        "burn-rate monitor: burn at/above this holds the "
                        "pool overloaded (0 = off, the default — queue/"
                        "page signals stay the sole policy)")
    return p


def main(argv=None) -> dict:
    """Run the fleet until SIGTERM/SIGINT; returns the final fleet stats."""
    args = build_parser().parse_args(argv)

    from pytorch_distributed_training_tpu_torch.analysis.concurrency import (
        get_lock_registry,
        guard_mode_from_env,
        start_periodic_summary,
    )
    from pytorch_distributed_training_tpu_torch.serve.fleet import (
        FleetConfig,
        ServeFleet,
    )
    from pytorch_distributed_training_tpu_torch.serve.router import (
        RouterConfig,
        make_router_http_server,
    )
    from pytorch_distributed_training_tpu_torch.telemetry.registry import (
        get_registry,
    )
    from pytorch_distributed_training_tpu_torch.utils.logging import log0

    # the same strict-by-default contract as serve_lm: the coordinator's
    # router/breaker/watcher locks run under the chosen discipline, and
    # the resolved mode is forwarded to every replica so the whole fleet
    # agrees
    guard_mode = args.guards or guard_mode_from_env(default="strict")
    get_lock_registry().mode = guard_mode

    registry = get_registry()
    sink = None
    if args.metrics_dir:
        from pytorch_distributed_training_tpu_torch.telemetry.sink import (
            JsonlSink,
        )

        sink = JsonlSink(args.metrics_dir, process_index=0)
        registry.attach_sink(sink)
        sink.emit({
            "record": "fleet_meta",
            "replicas": args.replicas,
            "model": args.model,
            "device": args.device,
            "tp": args.tp,
            "num_slots": args.num_slots,
            "max_restarts": args.max_restarts,
            "hedge_s": args.hedge_s,
        })

    replica_args = [
        "--model", args.model,
        "--seed", str(args.seed),
        "--device", args.device,
        "--num-slots", str(args.num_slots),
        "--prompt-buckets", args.prompt_buckets,
        "--max-new-tokens-cap", str(args.max_new_tokens_cap),
        "--queue-depth", str(args.queue_depth),
        "--deadline-s", str(args.deadline_s),
        "--kv-layout", args.kv_layout,
        "--page-size", str(args.page_size),
        "--num-pages", str(args.num_pages),
        "--sampling", args.sampling,
        "--guards", guard_mode,
    ]
    if args.tp > 1:
        replica_args += ["--tp", str(args.tp)]
    if args.lock_summary_s > 0:
        replica_args += ["--lock-summary-s", str(args.lock_summary_s)]
    if args.interactive_deadline_s > 0:
        replica_args += [
            "--interactive-deadline-s", str(args.interactive_deadline_s),
        ]
    if args.batch_deadline_s > 0:
        replica_args += ["--batch-deadline-s", str(args.batch_deadline_s)]
    if args.brownout_high > 0:
        replica_args += [
            "--brownout-high", str(args.brownout_high),
            "--brownout-low", str(args.brownout_low),
            "--brownout-clamp", str(args.brownout_clamp),
        ]
    for flag in ("checkpoint_dir", "hf_checkpoint", "vocab", "merges"):
        value = getattr(args, flag)
        if value:
            replica_args += ["--" + flag.replace("_", "-"), value]
    # per-replica identity rides every span the replica emits; pre-assign
    # up to the autoscaler's ceiling so scaled-up replicas are named too
    pool_ceiling = max(args.replicas, args.max_replicas)
    extra_args = {
        i: ("--replica-name", f"replica-{i}")
        for i in range(pool_ceiling)
    }
    if args.metrics_dir:
        # per-replica streams: a restarted replica appends to its own
        # file; pre-assign dirs up to the autoscaler's ceiling so scaled-
        # up replicas stream too
        extra_args = {
            i: extra_args[i] + (
                "--metrics-dir", f"{args.metrics_dir}/replica-{i}",
            )
            for i in range(pool_ceiling)
        }

    # coordinator-side SLO plane: the router feeds request outcomes into
    # the burn-rate monitor; the autoscaler only *acts* on it when
    # --slo-burn-high is set (default-off, like the brownout coupling)
    from pytorch_distributed_training_tpu_torch.telemetry.slo import (
        BurnRateMonitor,
        SloConfig,
    )

    slo_monitor = BurnRateMonitor(SloConfig(), registry=registry)

    fleet = ServeFleet(
        FleetConfig(
            num_replicas=args.replicas,
            replica_args=tuple(replica_args),
            replica_extra_args=extra_args,
            max_restarts=args.max_restarts,
            restart_window_s=args.restart_window_s,
            drain_timeout_s=args.drain_timeout_s,
            tp=args.tp,
        ),
        RouterConfig(
            hedge_s=args.hedge_s,
            max_retries=args.request_retries,
        ),
        registry=registry,
        slo_monitor=slo_monitor,
    )
    fleet.start()
    if args.hotswap_poll_s > 0 and args.checkpoint_dir:
        # the fleet process (no torch) runs the watcher; replicas receive
        # rollouts through POST /swap, one at a time — their own pollers
        # stay off so the rollout order is the coordinator's alone
        fleet.enable_hotswap(
            args.checkpoint_dir,
            poll_interval_s=args.hotswap_poll_s,
            verify_level=args.hotswap_verify,
        )
    autoscaler = None
    if args.max_replicas > 0:
        from pytorch_distributed_training_tpu_torch.serve.autoscale import (
            AutoscaleConfig,
            Autoscaler,
        )

        autoscaler = Autoscaler(
            fleet,
            AutoscaleConfig(
                min_replicas=args.min_replicas,
                max_replicas=max(args.max_replicas, args.replicas),
                scale_up_queue_depth=args.autoscale_up_depth,
                scale_down_queue_depth=args.autoscale_down_depth,
                up_hold_s=args.autoscale_up_hold_s,
                down_hold_s=args.autoscale_down_hold_s,
                up_cooldown_s=args.autoscale_up_cooldown_s,
                down_cooldown_s=args.autoscale_down_cooldown_s,
                poll_interval_s=args.autoscale_poll_s,
                slo_burn_high=args.slo_burn_high,
            ),
            registry=registry,
            slo_monitor=slo_monitor,
        ).start()
    httpd = make_router_http_server(fleet.router, port=args.router_port)
    log0(
        f"fleet router on http://127.0.0.1:{httpd.server_address[1]} "
        f"({args.replicas} replicas on ports "
        f"{[r.port for r in fleet.replicas]})"
    )

    lock_summary = None
    if args.lock_summary_s > 0:
        # coordinator-side cadence (router/breaker/watcher locks); each
        # replica runs its own via the forwarded --lock-summary-s flag
        lock_summary = start_periodic_summary(
            args.lock_summary_s, registry=registry
        )

    stop = threading.Event()

    def _on_signal(signum, frame):
        stop.set()
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)

    try:
        httpd.serve_forever()
    finally:
        log0("draining fleet")
        if lock_summary is not None:
            lock_summary.stop()
        if autoscaler is not None:
            autoscaler.close()
        fleet.stop(drain=True)
        stats = fleet.stats()
        if autoscaler is not None:
            stats["autoscale"] = autoscaler.stats()
        if sink is not None:
            sink.emit({"record": "fleet_summary", **stats})
            # the fleet process' own lock accounting (router/breaker/
            # watcher locks); replicas emit theirs into their own streams
            sink.emit(get_lock_registry().summary_record())
            sink.flush(fsync=True)
    return stats


if __name__ == "__main__":
    main()
