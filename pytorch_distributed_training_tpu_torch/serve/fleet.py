"""Replica-pool supervision: N serving subprocesses + the router, one unit
(counterpart: the JAX package's ``serve/fleet.py``, with the same
supervision contract, records and keys).

``ServeFleet`` turns ``cli/serve_lm.py`` (one replica = one process = one
HTTP port) into a supervised pool fronted by ``serve/router.py``:

- every replica runs under ``utils/supervisor.run_with_restarts``: a crash
  (any exit but 0/75) burns a restart from the budget and respawns after
  decorrelated-jitter backoff; an exhausted budget marks the replica
  ``failed`` and the pool runs degraded;
- exit 75 (``faults.preemption.RESUMABLE_EXIT_CODE``) is a GRACEFUL drain
  — the replica advertised ``draining`` on /healthz, finished its in-flight
  requests and left. The supervisor does NOT count it as a crash: the
  replica respawns immediately with the restart budget untouched;
- ``PDT_TPU_FAULT`` serve specs are routed per replica by their ``@rank``
  suffix (``replica_crash:5@1`` kills replica 1 at busy tick 5, replica 0
  never sees the spec).

Ports are assigned at replica construction and normally reused across
respawns; if the bind races another process (exit 76,
``PORT_IN_USE_EXIT_CODE``), the spawn path retries on a fresh port WITHOUT
burning a restart and tells the router to re-qualify the new address. The
pool itself is dynamic: ``scale_up()`` adds a replica through the same
spawn machinery and ``retire_replica()`` removes one through the graceful
SIGTERM -> exit-75 drain (no in-flight request dies) — the knobs
``serve/autoscale.py`` turns. Telemetry: ``replica_spawn`` /
``replica_exit`` / ``replica_drain`` / ``replica_port_retry`` /
``fleet_scale`` records in the fleet process's stream, which
``scripts/summarize_metrics.py`` folds into the fleet and storm sections.

A replica of ``tp`` ranks (``serve_lm --tp``) is a ``RankGroup``: the
fleet spawns the ranks itself with the process-group environment
(``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``
on a free port), SIGTERM goes to every rank (the followers run the
leader's calls until its stop message, so the drain is the leader's), and
the replica's exit status is the leader's, rank 0's: 75, 76 and 23 reach
``_spawn_and_wait`` as they are (JAX's ``fleet_lm --tp`` is one
``serve_lm`` process, whose status its supervisor reads). Once the
leader has exited the followers get a bounded wait, then are killed;
``stop()``/``kill()`` reach every rank, so no orphan keeps a card.

The module imports no torch: the fleet process does no device work — the
model and its kernels live in the replica subprocesses, each on the card
its ``--device`` names (several replicas may share one card).
"""

from __future__ import annotations

import dataclasses
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Optional

from pytorch_distributed_training_tpu_torch.analysis import concurrency
from pytorch_distributed_training_tpu_torch.cli.serve_lm import (
    PORT_IN_USE_EXIT_CODE,
)
from pytorch_distributed_training_tpu_torch.faults.inject import (
    _SERVE_KINDS,
)
from pytorch_distributed_training_tpu_torch.faults.preemption import (
    RESUMABLE_EXIT_CODE,
    Preempted,
)
from pytorch_distributed_training_tpu_torch.serve.hotswap import (
    CheckpointWatcher,
)
from pytorch_distributed_training_tpu_torch.serve.router import (
    Router,
    RouterConfig,
)
from pytorch_distributed_training_tpu_torch.telemetry.registry import (
    get_registry,
)
from pytorch_distributed_training_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

#: bind-race retries per supervised attempt before the exit is treated as
#: a real failure (each retry picks a fresh OS-assigned port, so repeated
#: losses mean something is systematically wrong, not bad luck)
MAX_PORT_RETRIES = 5

#: seconds the followers of a ``--tp`` replica get to exit after their
#: leader (its drain sent them the stop message) before they are killed
FOLLOWER_REAP_S = 10.0


def find_free_port(host: str = "127.0.0.1") -> int:
    """An OS-assigned free TCP port (released immediately). The probe is
    inherently TOCTOU — another process can claim the port before the
    replica binds it — so the spawn path closes the race the only reliable
    way: the replica exits ``PORT_IN_USE_EXIT_CODE`` when its bind fails
    and the supervisor retries on a fresh port without burning a restart."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host, 0))
        return s.getsockname()[1]


def _wait_exit(proc: subprocess.Popen, poll_s: float = 1.0) -> int:
    """``proc``'s exit status: the supervising thread's whole job is this
    wait, in bounded slices (``stop()``/``kill()`` end the child, which
    ends it)."""
    while True:
        try:
            return proc.wait(timeout=poll_s)
        except subprocess.TimeoutExpired:
            continue


def split_fault_specs(text: Optional[str]) -> dict:
    """Route a ``PDT_TPU_FAULT`` value to fleet members: serve-scoped specs
    go to the replica named by their ``@rank`` suffix (stripped — inside
    its own process every replica is rank 0); everything else is dropped
    from replica envs (a train-scoped spec must not fire in N serving
    processes at once). Returns ``{replica_index: "spec,spec"}``."""
    routed: dict[int, list] = {}
    if not text or not text.strip():
        return {}
    for raw in text.split(","):
        raw = raw.strip()
        if not raw:
            continue
        spec, rank = raw, 0
        if "@" in raw:
            spec, rank_s = raw.rsplit("@", 1)
            rank = int(rank_s)
        if spec.split(":", 1)[0] in _SERVE_KINDS:
            routed.setdefault(rank, []).append(spec)
    return {k: ",".join(v) for k, v in routed.items()}


@dataclasses.dataclass
class FleetConfig:
    """Pool shape + supervision policy. ``replica_args`` is the serve_lm
    argv tail shared by every replica (model/engine/queue knobs);
    ``replica_extra_args`` maps replica index -> extra argv for that
    replica only (e.g. its own --metrics-dir); ``replica_env`` overlays
    the inherited environment; ``fault_env`` maps replica index -> a
    PDT_TPU_FAULT value for that replica only."""

    num_replicas: int = 2
    replica_args: tuple = ()
    replica_extra_args: dict = dataclasses.field(default_factory=dict)
    replica_env: dict = dataclasses.field(default_factory=dict)
    fault_env: dict = dataclasses.field(default_factory=dict)
    max_restarts: int = 2
    restart_window_s: float = 0.0
    backoff_s: float = 0.25
    drain_timeout_s: float = 10.0
    spawn_timeout_s: float = 120.0
    host: str = "127.0.0.1"
    #: ranks per replica (``serve_lm --tp``, which ``replica_args`` must
    #: carry too): above 1, each replica is a ``RankGroup``
    tp: int = 1

    def __post_init__(self):
        if self.num_replicas < 1:
            raise ValueError(
                f"num_replicas must be >= 1, got {self.num_replicas}"
            )


class ReplicaCrashed(RuntimeError):
    """A replica exited with a non-graceful status (anything but 0/75)."""

    def __init__(self, name: str, returncode: int):
        super().__init__(f"replica {name} exited rc={returncode}")
        self.returncode = returncode


class RankGroup:
    """The ``tp`` ranks of one ``serve_lm --tp`` replica, answering as the
    ``subprocess.Popen`` of its leader: ``pid``, ``poll`` and ``wait`` are
    rank 0's (``wait`` then reaps the followers: a bounded wait, then a
    kill), ``send_signal``/``kill`` reach every rank still running."""

    def __init__(self, argv: list, env: dict, tp: int, host: str):
        master_port = find_free_port(host)
        self.procs = [
            subprocess.Popen(argv, env={
                **env, "RANK": str(rank), "LOCAL_RANK": str(rank),
                "WORLD_SIZE": str(tp), "LOCAL_WORLD_SIZE": str(tp),
                "MASTER_ADDR": host, "MASTER_PORT": str(master_port),
            }, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
            for rank in range(tp)
        ]
        self.pid = self.procs[0].pid

    def poll(self) -> Optional[int]:
        return self.procs[0].poll()

    def wait(self, timeout: Optional[float] = None) -> int:
        rc = self.procs[0].wait(timeout)
        self._reap()
        return rc

    def _reap(self) -> None:
        deadline = time.monotonic() + FOLLOWER_REAP_S
        for proc in self.procs[1:]:
            try:
                proc.wait(max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(5.0)

    def send_signal(self, signum: int) -> None:
        for proc in self.procs:
            if proc.poll() is None:
                proc.send_signal(signum)

    def kill(self) -> None:
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()


class ReplicaProcess:
    """One supervised serving subprocess (or ``RankGroup``) on a fixed
    port."""

    def __init__(self, index: int, port: int, fleet_cfg: FleetConfig,
                 registry):
        self.index = index
        self.name = f"r{index}"
        self.port = port
        self._cfg = fleet_cfg
        self._registry = registry
        self.proc = None    # subprocess.Popen, or a RankGroup
        self.state = "starting"     # starting|up|failed|stopped
        self.restarts_used = 0
        self.graceful_exits = 0
        self.spawns = 0
        self.port_retries = 0
        # fleet wires this to the router so a bind-race port change
        # propagates to the endpoint the health poll re-qualifies
        self.on_port_change = None
        self._stopping = threading.Event()
        # the monitor thread mutates proc/state/counters; sigterm()/stop()/
        # describe() run on the fleet's control threads — one lock covers
        # the handoff (linter: thread-shared-mutable on _sigterm_t & co).
        # Held only for field updates, never across proc.wait()/IO.
        self._lock = concurrency.lock("serve.fleet.replica")
        self._sigterm_t: Optional[float] = None
        self._thread = threading.Thread(
            target=self._monitor, name=f"fleet-{self.name}", daemon=True
        )

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "ReplicaProcess":
        self._export_budget()
        self._thread.start()
        return self

    def budget_remaining(self) -> int:
        """Restarts left before this replica goes ``failed`` for good."""
        with self._lock:
            return max(0, self._cfg.max_restarts - self.restarts_used)

    def _export_budget(self) -> None:
        # per-replica gauge: a storm that eats the restart budget shows up
        # as this hitting 0, in telemetry instead of log archaeology
        self._registry.gauge(
            f"fleet/restart_budget_remaining/{self.name}",
            self.budget_remaining(),
        )

    def _argv(self) -> list:
        return [
            sys.executable, "-m",
            "pytorch_distributed_training_tpu_torch.cli.serve_lm",
            "--http-port", str(self.port),
            "--http-host", self._cfg.host,
            "--drain-timeout-s", str(self._cfg.drain_timeout_s),
            *self._cfg.replica_args,
            *self._cfg.replica_extra_args.get(self.index, ()),
        ]

    def _env(self) -> dict:
        env = dict(os.environ)
        env.update(self._cfg.replica_env)
        # fault routing: only THIS replica's serve-scoped specs survive
        env.pop("PDT_TPU_FAULT", None)
        fault = self._cfg.fault_env.get(self.index)
        if fault:
            env["PDT_TPU_FAULT"] = fault
        return env

    def _launch(self):
        """The replica's process: ``serve_lm``, or under ``tp > 1`` its
        ``RankGroup`` (serve_lm's own contract: ``--tp`` equals the world
        size)."""
        if self._cfg.tp > 1:
            return RankGroup(self._argv(), self._env(), self._cfg.tp,
                             self._cfg.host)
        return subprocess.Popen(
            self._argv(), env=self._env(),
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )

    def _spawn_and_wait(self, attempt: int) -> None:
        """One supervised attempt: spawn, record, wait, classify the exit.

        A bind-race exit (``PORT_IN_USE_EXIT_CODE``) loops HERE, inside the
        attempt — a fresh port, a router rebind notification, respawn — so
        ``run_with_restarts`` never sees it and the restart budget stays
        whole. Only repeated losses (``MAX_PORT_RETRIES``) fall through to
        the crash path."""
        port_tries = 0
        while True:
            proc = self._launch()
            with self._lock:
                self.spawns += 1
                self.proc = proc
                self.state = "up"
            logger.info(
                "replica %s spawned pid=%d port=%d attempt=%d",
                self.name, proc.pid, self.port, attempt,
            )
            self._registry.emit({
                "record": "replica_spawn",
                "replica": self.name,
                "pid": proc.pid,
                "port": self.port,
                "attempt": attempt,
            })
            rc = _wait_exit(proc)
            if (
                rc != PORT_IN_USE_EXIT_CODE
                or self._stopping.is_set()
                or port_tries >= MAX_PORT_RETRIES
            ):
                break
            port_tries += 1
            old_port = self.port
            new_port = find_free_port(self._cfg.host)
            with self._lock:
                self.port = new_port
                self.port_retries += 1
            logger.warning(
                "replica %s lost the bind race on port %d; retrying on "
                "%d (%d/%d)", self.name, old_port, new_port,
                port_tries, MAX_PORT_RETRIES,
            )
            self._registry.inc("fleet/port_retries")
            self._registry.emit({
                "record": "replica_port_retry",
                "replica": self.name,
                "old_port": old_port,
                "new_port": new_port,
                "try": port_tries,
            })
            cb = self.on_port_change
            if cb is not None:
                cb(self)
        graceful = rc == RESUMABLE_EXIT_CODE
        with self._lock:
            sigterm_t = self._sigterm_t
            self._sigterm_t = None
        drain_s = (
            time.monotonic() - sigterm_t
            if graceful and sigterm_t is not None
            else None
        )
        self._registry.emit({
            "record": "replica_exit",
            "replica": self.name,
            "rc": rc,
            "graceful": graceful,
            **({"drain_s": drain_s} if drain_s is not None else {}),
        })
        if graceful:
            with self._lock:
                self.graceful_exits += 1
            if drain_s is not None:
                self._registry.emit({
                    "record": "replica_drain",
                    "replica": self.name,
                    "drain_s": drain_s,
                })
            raise Preempted(signal.SIGTERM)
        if rc != 0 and not self._stopping.is_set():
            self._registry.inc("fleet/replica_crashes")
            raise ReplicaCrashed(self.name, rc)

    def _monitor(self) -> None:
        """Supervision loop: ``run_with_restarts`` handles the crash path
        (budget + decorrelated-jitter backoff); a graceful exit-75 drain
        propagates as ``Preempted`` WITHOUT burning a restart, and the
        replica respawns immediately — a preempted replica is capacity to
        restore, not a failure to count."""
        from pytorch_distributed_training_tpu_torch.utils.supervisor import (
            run_with_restarts,
        )

        while not self._stopping.is_set():
            try:
                run_with_restarts(
                    self._attempt,
                    max_restarts=self._cfg.max_restarts,
                    backoff_s=self._cfg.backoff_s,
                    restart_window_s=self._cfg.restart_window_s,
                    max_backoff_s=max(self._cfg.backoff_s * 4, 1.0),
                )
                with self._lock:
                    self.state = "stopped"
                return
            except Preempted:
                if self._stopping.is_set():
                    with self._lock:
                        self.state = "stopped"
                    return
                logger.info(
                    "replica %s drained gracefully; respawning without "
                    "burning a restart", self.name,
                )
                continue
            except ReplicaCrashed:
                logger.error(
                    "replica %s exhausted its restart budget; pool runs "
                    "degraded", self.name,
                )
                with self._lock:
                    self.state = "failed"
                    restarts_used = self.restarts_used
                self._registry.emit({
                    "record": "replica_failed",
                    "replica": self.name,
                    "restarts_used": restarts_used,
                })
                return

    def _attempt(self, i: int) -> None:
        if i > 0:
            with self._lock:
                self.restarts_used += 1
            self._export_budget()
        if self._stopping.is_set():
            return
        self._spawn_and_wait(i)

    # -------------------------------------------------------------- control

    def sigterm(self) -> None:
        """Graceful drain request (the preemption signal)."""
        with self._lock:
            proc = self.proc
            if proc is None or proc.poll() is not None:
                return
            self._sigterm_t = time.monotonic()
        proc.send_signal(signal.SIGTERM)

    def kill(self) -> None:
        with self._lock:
            proc = self.proc
        if proc is not None and proc.poll() is None:
            proc.kill()

    def stop(self, *, drain: bool = True) -> None:
        """Terminate and stop respawning. ``drain=True`` sends SIGTERM and
        allows the drain window; ``drain=False`` kills immediately."""
        self._stopping.set()
        if drain:
            self.sigterm()
        else:
            self.kill()

    def join(self, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        self._thread.join(timeout)
        with self._lock:
            proc = self.proc
        if proc is not None and proc.poll() is None:
            try:
                proc.wait(max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                logger.error(
                    "replica %s did not exit within the drain window; "
                    "killing", self.name,
                )
                proc.kill()
                proc.wait(5.0)

    def describe(self) -> dict:
        with self._lock:
            proc = self.proc
            state = self.state
            spawns = self.spawns
            restarts_used = self.restarts_used
            graceful_exits = self.graceful_exits
            port = self.port
            port_retries = self.port_retries
        return {
            "replica": self.name,
            "port": port,
            "state": state,
            "pid": proc.pid if proc is not None else None,
            "alive": proc is not None and proc.poll() is None,
            "spawns": spawns,
            "restarts_used": restarts_used,
            "restart_budget_remaining": max(
                0, self._cfg.max_restarts - restarts_used
            ),
            "graceful_exits": graceful_exits,
            "port_retries": port_retries,
        }


class RollingSwapCoordinator:
    """One-replica-at-a-time checkpoint rollout across the pool.

    The fleet process runs the SAME ``CheckpointWatcher`` a standalone
    replica would (manifest scan + verify only, no torch) and, for each
    admitted step, drives the replicas' ``POST /swap`` endpoints in index
    order — strictly one at a time, waiting for each replica's synchronous
    outcome before touching the next, so at most one replica is ever
    mid-swap and the pool's serving capacity never dips.

    Failure policy mirrors the replica-side contract: a replica whose swap
    fails (409, connection error, timeout) KEEPS its old weights and stays
    in rotation — degraded-version, not dead — and the rollout continues
    to the next replica. A step no replica could take is blocklisted by
    the watcher (poisoned publish: never retried); a partially-rolled-out
    step is also never re-driven — convergence comes from the next good
    step, or from a respawned replica booting on the newest verified step.
    Telemetry: per-replica ``fleet_swap_replica`` records and one
    ``fleet_swap`` rollout record (duration = the version-skew window the
    router independently measures via ``router_skew``).
    """

    def __init__(
        self,
        fleet: "ServeFleet",
        checkpoint_dir: str,
        *,
        poll_interval_s: float = 0.5,
        verify_level: str = "digest",
        registry=None,
        swap_timeout_s: float = 120.0,
    ):
        self._fleet = fleet
        self._registry = registry if registry is not None else fleet._registry
        self.swap_timeout_s = swap_timeout_s
        self.rollouts = 0
        self.rollouts_converged = 0
        self.watcher = CheckpointWatcher(
            checkpoint_dir,
            self._rollout,
            poll_interval_s=poll_interval_s,
            verify_level=verify_level,
            registry=self._registry,
            name="fleet-hotswap",
        )

    def start(self) -> "RollingSwapCoordinator":
        self.watcher.start()
        return self

    def close(self) -> None:
        self.watcher.close()

    def _eligible(self, replica: ReplicaProcess) -> bool:
        """Only roll a replica that is up and in rotation: one mid-boot is
        skipped (it boots on the newest verified step anyway), one failed
        or draining has no swap to receive."""
        proc = replica.proc
        if replica.state != "up" or proc is None or proc.poll() is not None:
            return False
        view = next(
            (r for r in self._fleet.router.replicas
             if r.name == replica.name), None,
        )
        return view is not None and view.available()

    def _swap_replica(self, replica: ReplicaProcess, step: int) -> dict:
        import http.client
        import json

        try:
            conn = http.client.HTTPConnection(
                self._fleet.config.host, replica.port,
                timeout=self.swap_timeout_s,
            )
            try:
                conn.request(
                    "POST", "/swap",
                    body=json.dumps({"step": step}),
                    headers={"Content-Type": "application/json"},
                )
                resp = conn.getresponse()
                out = json.loads(resp.read() or b"{}")
            finally:
                conn.close()
            out.setdefault("ok", False)
            return out
        except Exception as e:      # conn refused/reset/timeout (e.g. the
            # swap_crash drill killing the replica mid-load)
            return {"ok": False, "stage": "http", "error": repr(e)}

    def _rollout(self, step: int) -> bool:
        """Watcher apply hook: roll ``step`` across the pool. True unless
        NO replica could take it (which blocklists the step)."""
        t0 = time.monotonic()
        self.rollouts += 1
        results: dict[str, str] = {}
        for replica in self._fleet.replicas:
            if not self._eligible(replica):
                results[replica.name] = "skipped"
                continue
            r0 = time.monotonic()
            out = self._swap_replica(replica, step)
            ok = bool(out.get("ok"))
            results[replica.name] = "ok" if ok else "failed"
            self._registry.inc(
                "fleet/swap_ok" if ok else "fleet/swap_failed"
            )
            self._registry.emit({
                "record": "fleet_swap_replica",
                "step": step,
                "replica": replica.name,
                "ok": ok,
                "duration_s": time.monotonic() - r0,
                **({} if ok else {
                    "stage": out.get("stage"),
                    "error": out.get("error"),
                }),
            })
            if not ok:
                logger.warning(
                    "rolling swap: replica %s refused step %d (%s); it "
                    "stays on its old weights", replica.name, step,
                    out.get("error"),
                )
        ok_n = sum(1 for v in results.values() if v == "ok")
        fail_n = sum(1 for v in results.values() if v == "failed")
        converged = fail_n == 0
        self._registry.emit({
            "record": "fleet_swap",
            "step": step,
            "results": results,
            "ok": ok_n,
            "failed": fail_n,
            "skipped": len(results) - ok_n - fail_n,
            "duration_s": time.monotonic() - t0,
            "converged": converged,
        })
        if converged:
            self.rollouts_converged += 1
        # a step EVERY eligible replica rejected is poisoned — blocklist it
        # (False); a partial or skipped rollout still advances (the step is
        # live somewhere, or nobody was up to take it and respawns will
        # boot straight onto it)
        return ok_n > 0 or fail_n == 0

    def stats(self) -> dict:
        return {
            "rollouts": self.rollouts,
            "rollouts_converged": self.rollouts_converged,
            "current_step": self.watcher.current_step,
            "blocklist": sorted(self.watcher.blocklist),
        }


class ServeFleet:
    """N supervised replicas + one router, started and stopped together."""

    def __init__(
        self,
        fleet_config: FleetConfig,
        router_config: Optional[RouterConfig] = None,
        *,
        registry=None,
        slo_monitor=None,
    ):
        if registry is None:
            registry = get_registry()
        self._registry = registry
        self.config = fleet_config
        if not fleet_config.fault_env:
            fleet_config.fault_env = split_fault_specs(
                os.environ.get("PDT_TPU_FAULT")
            )
        self.replicas = [
            ReplicaProcess(
                i, find_free_port(fleet_config.host), fleet_config, registry
            )
            for i in range(fleet_config.num_replicas)
        ]
        self.router = Router(
            [(r.name, fleet_config.host, r.port) for r in self.replicas],
            router_config,
            registry=registry,
            slo_monitor=slo_monitor,
        )
        self.router.pool_status_fn = self.pool_status
        # pool membership changes (autoscaler scale-up/retire) vs the
        # readers in stop/stats/rolling-swap: mutations replace the list
        # atomically under this lock, readers snapshot it
        self._pool_lock = concurrency.lock("serve.fleet.pool")
        self._next_index = fleet_config.num_replicas
        self.scale_ups = 0
        self.scale_downs = 0
        for replica in self.replicas:
            replica.on_port_change = self._port_changed
        self.hotswap: Optional[RollingSwapCoordinator] = None

    def _port_changed(self, replica: ReplicaProcess) -> None:
        self.router.update_endpoint_port(replica.name, replica.port)

    def enable_hotswap(
        self,
        checkpoint_dir: str,
        *,
        poll_interval_s: float = 0.5,
        verify_level: str = "digest",
        swap_timeout_s: float = 120.0,
    ) -> RollingSwapCoordinator:
        """Attach (and start) the rolling-swap coordinator: new verified
        checkpoint steps under ``checkpoint_dir`` roll across the pool one
        replica at a time with no restart."""
        if self.hotswap is not None:
            raise RuntimeError("fleet hot-swap already enabled")
        self.hotswap = RollingSwapCoordinator(
            self, checkpoint_dir,
            poll_interval_s=poll_interval_s,
            verify_level=verify_level,
            registry=self._registry,
            swap_timeout_s=swap_timeout_s,
        ).start()
        return self.hotswap

    def start(self) -> "ServeFleet":
        for replica in self.replicas:
            replica.start()
        self.router.start()
        return self

    def wait_ready(self, timeout: Optional[float] = None,
                   min_replicas: Optional[int] = None) -> bool:
        """Block until ``min_replicas`` (default: all) replicas are in
        rotation — replica boot includes a torch import and model init, so
        first readiness takes seconds even for a tiny model."""
        timeout = self.config.spawn_timeout_s if timeout is None else timeout
        want = (
            len(self.replicas) if min_replicas is None else min_replicas
        )
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.router.available_count() >= want:
                return True
            time.sleep(0.05)
        return self.router.available_count() >= want

    def replica(self, index: int) -> ReplicaProcess:
        return self.replicas[index]

    # -------------------------------------------------------- dynamic pool

    def scale_up(self) -> ReplicaProcess:
        """Add one replica through the normal spawn machinery. It takes
        traffic only after the router's health poll qualifies it (the
        add_endpoint readiness gate), so callers can fire-and-forget."""
        with self._pool_lock:
            index = self._next_index
            self._next_index += 1
            replica = ReplicaProcess(
                index, find_free_port(self.config.host), self.config,
                self._registry,
            )
            replica.on_port_change = self._port_changed
            self.replicas = self.replicas + [replica]
            self.scale_ups += 1
        self.router.add_endpoint(replica.name, self.config.host, replica.port)
        replica.start()
        self._registry.inc("fleet/scale_ups")
        self._registry.emit({
            "record": "fleet_scale",
            "action": "up",
            "replica": replica.name,
            "port": replica.port,
            "size": len(self.replicas),
        })
        return replica

    def retire_replica(self) -> Optional[str]:
        """Remove one replica gracefully: SIGTERM -> drain -> exit 75, the
        same path a preemption takes, so every in-flight request finishes.
        Newest capacity leaves first (LIFO keeps the stable seed replicas).
        Refuses to retire the last live replica. Returns the retiring
        replica's name immediately; a background waiter deregisters it
        from the router once the drain completes."""
        with self._pool_lock:
            live = [
                r for r in self.replicas if r.state in ("starting", "up")
            ]
            if len(live) <= 1:
                return None
            replica = live[-1]
        t0 = time.monotonic()
        replica.stop(drain=True)

        def _finish() -> None:
            replica.join(self.config.drain_timeout_s + 10.0)
            with self._pool_lock:
                self.replicas = [r for r in self.replicas if r is not replica]
                self.scale_downs += 1
            self.router.remove_endpoint(replica.name)
            self._registry.inc("fleet/scale_downs")
            self._registry.emit({
                "record": "fleet_scale",
                "action": "down",
                "replica": replica.name,
                "drain_s": time.monotonic() - t0,
                "size": len(self.replicas),
            })

        threading.Thread(
            target=_finish, name=f"fleet-retire-{replica.name}", daemon=True
        ).start()
        return replica.name

    def pool_status(self) -> dict:
        """Pool health for /stats and the router's fail-fast body. A pool
        is ``degraded`` when any member exhausted its restart budget — the
        failure mode client backoff cannot fix."""
        replicas = list(self.replicas)
        failed = [r.name for r in replicas if r.state == "failed"]
        return {
            "size": len(replicas),
            "up": sum(1 for r in replicas if r.state == "up"),
            "failed": failed,
            "degraded": bool(failed),
            "reason": (
                "pool degraded: restart budget exhausted for "
                + ",".join(failed)
                if failed else None
            ),
            "restart_budget_remaining": {
                r.name: r.budget_remaining() for r in replicas
            },
        }

    def stop(self, *, drain: bool = True) -> None:
        """Drain (or kill) every replica, stop respawns, stop the router
        (and the rollout coordinator first — no swap starts mid-drain)."""
        if self.hotswap is not None:
            self.hotswap.close()
        replicas = list(self.replicas)
        for replica in replicas:
            replica.stop(drain=drain)
        join_s = self.config.drain_timeout_s + 10.0 if drain else 10.0
        for replica in replicas:
            replica.join(join_s)
        self.router.close()

    def stats(self) -> dict:
        stats = {
            "replicas": [r.describe() for r in list(self.replicas)],
            "router": self.router.stats(),
            "pool": self.pool_status(),
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
        }
        if self.hotswap is not None:
            stats["hotswap"] = self.hotswap.stats()
        return stats
