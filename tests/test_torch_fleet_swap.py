"""Port parity, the fleet's pool changes end to end with real port
``serve_lm`` replicas (gpt2-tiny, ``--device cpu``): the rolling swap
(``RollingSwapCoordinator``) takes a newly published step one replica at
a time under a closed loop with zero failed requests and converges with
version skew 0; a ``corrupt_ckpt_swap`` publish is rolled back on every
replica, blocklisted, and the fleet converges on the next good step with
no restart. ``retire_replica`` (the autoscaler's scale-down) drains an
in-flight 64-token stream through SIGTERM and exit 75.

JAX's own fleet swap drills do not pass on this tree, so these pin the
contract its tests document (the corrupt-publish and strict-lock fleet
drills of ``tests/test_hotswap.py`` and ``tests/test_concurrency.py``)
rather than a JAX run."""

import http.client
import json
import threading

import pytest
import torch

from pytorch_distributed_training_tpu_torch.models.gpt2 import GPT2LMModel
from pytorch_distributed_training_tpu_torch.serve import (
    publish_params_checkpoint,
)
from pytorch_distributed_training_tpu_torch.serve.fleet import (
    FleetConfig,
    ServeFleet,
)
from pytorch_distributed_training_tpu_torch.serve.router import (
    RouterConfig,
    make_router_http_server,
)
from pytorch_distributed_training_tpu_torch.serve.server import wait_until
from pytorch_distributed_training_tpu_torch.telemetry.registry import (
    MetricsRegistry,
)
from pytorch_distributed_training_tpu_torch.utils.config import model_preset
from test_torch_fleet import REPLICA_ARGS, ListSink, _post_generate

pytestmark = [pytest.mark.serve, pytest.mark.swap, pytest.mark.chaos]

torch.set_num_threads(2)

ROUTER = dict(health_interval_s=0.05, health_timeout_s=1.0,
              breaker_threshold=3, breaker_cooldown_s=0.5,
              retry_backoff_s=0.02, retry_backoff_max_s=0.1,
              ttfb_timeout_s=60.0)


@pytest.fixture(autouse=True)
def _one_thread_replicas(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.delenv("PDT_TPU_FAULT", raising=False)


def _registry():
    reg, sink = MetricsRegistry(), ListSink()
    reg.attach_sink(sink)
    return reg, sink


def _replica_stats(port):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", "/stats")
    payload = json.loads(conn.getresponse().read())
    conn.close()
    return payload


def _wave(port, tag, n):
    results = [None] * n

    def run(i):
        results[i] = _post_generate(port, f"{tag} request {i}", 6,
                                    f"{tag}-{i}")

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    return results, threads


def _join(results, threads):
    for t in threads:
        t.join(180)
    assert not any(t.is_alive() for t in threads)
    return [r["outcome"] for r in results]


def test_rolling_swap_converges_and_corrupt_publish_rolls_back(tmp_path):
    torch.manual_seed(0)
    model = GPT2LMModel(model_preset("gpt2-tiny", compute_dtype="float32"))
    weights = model.state_dict()
    scaled = {k: v * 1.01 if v.is_floating_point() else v
              for k, v in weights.items()}
    ckpt = str(tmp_path / "ckpt")
    publish_params_checkpoint(ckpt, 1, weights)
    reg, sink = _registry()
    fleet = ServeFleet(
        FleetConfig(num_replicas=2,
                    replica_args=REPLICA_ARGS + ("--checkpoint-dir", ckpt),
                    # both replicas refuse the load of step 3
                    fault_env={0: "corrupt_ckpt_swap:3",
                               1: "corrupt_ckpt_swap:3"},
                    replica_env={"PDT_TPU_GUARDS": "strict"},
                    max_restarts=1, backoff_s=0.2, drain_timeout_s=20.0),
        RouterConfig(**ROUTER), registry=reg).start()
    httpd = None
    try:
        assert fleet.wait_ready(timeout=120), fleet.stats()
        assert fleet.router.stats()["weights"] == {"r0": 1, "r1": 1}
        fleet.enable_hotswap(ckpt, poll_interval_s=0.1)
        # the watcher's first poll takes the booted step as its baseline;
        # a step published before it would become the baseline instead
        assert wait_until(lambda: sink.of("swap_baseline"), timeout=30)
        httpd = make_router_http_server(fleet.router)
        port = httpd.server_address[1]
        threading.Thread(target=httpd.serve_forever, daemon=True).start()

        # a good step rolls out under a closed loop: no request fails
        wave = _wave(port, "roll", 6)
        publish_params_checkpoint(ckpt, 2, scaled)
        assert _join(*wave) == ["done"] * 6, wave[0]
        assert wait_until(
            lambda: fleet.router.stats()["weights"] == {"r0": 2, "r1": 2}
            and fleet.router.version_skew() == 0, timeout=120), (
            fleet.router.stats())
        [roll2] = [r for r in sink.of("fleet_swap") if r["step"] == 2]
        assert roll2["results"] == {"r0": "ok", "r1": "ok"}
        assert roll2["converged"] is True
        # one replica at a time, in index order
        per = [r["replica"] for r in sink.of("fleet_swap_replica")
               if r["step"] == 2]
        assert per == ["r0", "r1"]

        # a corrupt publish: every replica rolls back, the step is
        # blocklisted, the old weights keep serving, nothing fails
        wave = _wave(port, "corrupt", 6)
        publish_params_checkpoint(ckpt, 3, weights)
        assert _join(*wave) == ["done"] * 6, wave[0]
        assert wait_until(lambda: any(r["step"] == 3
                                      for r in sink.of("fleet_swap")),
                          timeout=60)
        [roll3] = [r for r in sink.of("fleet_swap") if r["step"] == 3]
        assert roll3["failed"] == 2 and roll3["ok"] == 0
        assert roll3["converged"] is False
        assert wait_until(lambda: 3 in fleet.hotswap.watcher.blocklist,
                          timeout=30)
        for replica in fleet.replicas:
            st = _replica_stats(replica.port)
            assert st["swap_failures"] >= 1 and st["weights_step"] == 2, st
        assert fleet.router.stats()["weights"] == {"r0": 2, "r1": 2}

        # the next good step: converged on both, no replica restarted
        publish_params_checkpoint(ckpt, 4, weights)
        assert wait_until(
            lambda: fleet.router.stats()["weights"] == {"r0": 4, "r1": 4}
            and fleet.router.version_skew() == 0, timeout=120), (
            fleet.router.stats())
        [roll4] = [r for r in sink.of("fleet_swap") if r["step"] == 4]
        assert roll4["ok"] == 2 and roll4["converged"] is True
        for replica in fleet.replicas:
            d = replica.describe()
            assert d["spawns"] == 1 and d["restarts_used"] == 0, d
            st = _replica_stats(replica.port)
            assert st["weights_step"] == 4 and st["swaps"] >= 2, st
        assert fleet.hotswap.stats()["rollouts"] == 3
        assert fleet.hotswap.stats()["rollouts_converged"] == 2
        # the router's version-skew view ends converged
        assert sink.of("router_skew")[-1]["skew"] == 0
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        fleet.stop(drain=False)


def test_retire_replica_drains_in_flight_64_token_stream():
    reg, sink = _registry()
    fleet = ServeFleet(
        FleetConfig(num_replicas=2, replica_args=REPLICA_ARGS,
                    max_restarts=1, backoff_s=0.2, drain_timeout_s=20.0),
        RouterConfig(**ROUTER), registry=reg).start()
    try:
        assert fleet.wait_ready(timeout=120), fleet.stats()
        # retire_replica takes the newest live replica (r1): stream
        # straight to its port so the request is provably on the retiree
        target = fleet.replica(1)
        events, client_done = [], threading.Event()

        def client():
            try:
                conn = http.client.HTTPConnection("127.0.0.1", target.port,
                                                  timeout=120)
                conn.request("POST", "/generate", body=json.dumps({
                    "prompt": "a long scale-down drain drill",
                    "max_new_tokens": 64, "tier": "interactive"}),
                    headers={"X-Request-Id": "retire-64"})
                resp = conn.getresponse()
                while True:
                    line = resp.readline()
                    if not line:
                        break
                    events.append(json.loads(line))
                conn.close()
            finally:
                client_done.set()

        threading.Thread(target=client, daemon=True).start()
        assert wait_until(lambda: len(events) >= 2, timeout=60), events
        assert fleet.retire_replica() == "r1"
        assert client_done.wait(120)
        assert events[-1]["event"] == "done", events[-3:]
        assert events[-1]["new_tokens"] == 64
        assert wait_until(lambda: any(r["replica"] == "r1" for r in
                                      sink.of("replica_exit")), timeout=60)
        [exit_rec] = [r for r in sink.of("replica_exit")
                      if r["replica"] == "r1"]
        assert exit_rec["graceful"] is True and exit_rec["rc"] == 75
        assert wait_until(lambda: any(r["action"] == "down" for r in
                                      sink.of("fleet_scale")), timeout=60)
        [down] = [r for r in sink.of("fleet_scale") if r["action"] == "down"]
        assert down["replica"] == "r1" and down["drain_s"] > 0
        assert down["size"] == 1
        # the pool shrank; the retiree did not respawn
        assert wait_until(lambda: [r.name for r in fleet.router.replicas]
                          == ["r0"], timeout=30)
        assert [r.name for r in fleet.replicas] == ["r0"]
        assert fleet.scale_downs == 1
        assert fleet.replica(0).describe()["restarts_used"] == 0
        assert fleet.retire_replica() is None       # never the last one
        post = _post_generate(fleet.replica(0).port, "post retire", 4,
                              "post-retire")
        assert post["outcome"] == "done", post
    finally:
        fleet.stop(drain=False)
