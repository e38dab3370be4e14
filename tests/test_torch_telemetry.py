"""Port parity, telemetry: the PyTorch package's registry, JSONL sink,
straggler stats and ``--log-format json`` (``telemetry/``,
``utils/logging.py``) against the JAX package's, on the CPU.

The same tiny run in both packages with a metrics directory writes the
same record types in the same order with the same keys (the port's
``run_meta`` adds its own three), and ``scripts/summarize_metrics.py``
folds both; over 2 gloo ranks the straggler gather names the slower rank
(exact stats from given step times), and a 2-rank ``train_dp`` run (one
rank slowed by ``slow_host``) writes both ranks' stats. The checks are of
schema, order and exact values; no tolerance is needed.
"""

import importlib.util
import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.telemetry.registry import (
    MetricsRegistry as JaxRegistry,
)
from pytorch_distributed_training_tpu.telemetry.straggler import (
    epoch_straggler_stats as jax_straggler,
)
from pytorch_distributed_training_tpu.train.loop import Trainer as JaxTrainer
from pytorch_distributed_training_tpu.utils.config import (
    MeshConfig as JaxMeshConfig,
)
from pytorch_distributed_training_tpu.utils.config import (
    TrainConfig as JaxTrainConfig,
)
from pytorch_distributed_training_tpu.utils.config import (
    model_preset as jax_preset,
)
from pytorch_distributed_training_tpu_torch.telemetry.registry import (
    MetricsRegistry,
    set_registry,
)
from pytorch_distributed_training_tpu_torch.telemetry.sink import JsonlSink
from pytorch_distributed_training_tpu_torch.telemetry.straggler import (
    epoch_straggler_stats,
)
from pytorch_distributed_training_tpu_torch.train.loop import Trainer
from pytorch_distributed_training_tpu_torch.utils import logging as plog
from pytorch_distributed_training_tpu_torch.utils.config import (
    TrainConfig,
    model_preset,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = dict(num_epochs=1, train_size=64, eval_size=32, global_batch_size=16,
           micro_batch_size=8, eval_batch_size=16, warmup_steps=1,
           log_every=0, bf16=False, max_seq_length=32)


def _records(path):
    with open(os.path.join(path, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _summarize():
    spec = importlib.util.spec_from_file_location(
        "summarize_metrics", os.path.join(REPO, "scripts",
                                          "summarize_metrics.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """One tiny synthetic run in each package with a metrics directory:
    both without the warm start and the guards (their records differ:
    JAX's donation audit has no counterpart), the JAX run on its 8-device
    CPU mesh; both with the Python loader and
    no prefetch, whose stall timers depend on the thread timing."""
    root = tmp_path_factory.mktemp("streams")
    jdir, pdir = str(root / "jax"), str(root / "port")
    prev = set_registry(None)
    try:
        JaxTrainer(
            jax_preset("tiny", compute_dtype="float32"),
            JaxTrainConfig(**RUN, metrics_dir=jdir, aot_warmup=False,
                           guards="off", prefetch_depth=0,
                           native_loader="off"),
            JaxMeshConfig(data=8), task="synthetic").run()
        Trainer(model_preset("tiny", compute_dtype="float32"),
                TrainConfig(**RUN, metrics_dir=pdir, prefetch_depth=0,
                            native_loader="off", aot_warmup=False,
                            guards="off"), task="synthetic",
                device="cpu").run()
    finally:
        set_registry(prev)
    return _records(jdir), _records(pdir), jdir, pdir


def test_same_record_types_order_and_keys_as_jax(streams):
    jax_recs, port_recs, _, _ = streams
    assert [r["record"] for r in port_recs] == [r["record"]
                                                for r in jax_recs]
    assert [r["record"] for r in port_recs] == (
        ["run_meta"] + ["step"] * 4 + ["epoch"])
    for j, p in zip(jax_recs, port_recs):
        if j["record"] == "run_meta":
            assert set(j) <= set(p)
            assert set(p) - set(j) == {"rank", "torch_version",
                                       "device_name"}
            assert set(p["config"]) == set(j["config"]) == {"model",
                                                            "train"}
            assert p["mesh_shape"] == {**j["mesh_shape"], "data": 1}
        else:
            assert set(p) == set(j), j["record"]
        if j["record"] == "epoch":
            assert set(p["straggler"]) == set(j["straggler"])
            assert set(p["telemetry"]) == set(j["telemetry"])
            assert set(p["telemetry"]["timers"]) == set(
                j["telemetry"]["timers"])
        if j["record"] == "step":
            assert (p["step"], p["compile_inclusive"]) == (
                j["step"], j["compile_inclusive"])


def test_summarize_metrics_reads_both_streams(streams):
    _, _, jdir, pdir = streams
    mod = _summarize()
    out = {}
    for name, d in (("jax", jdir), ("port", pdir)):
        s = mod.summarize(mod.load_records(d))
        assert len(s["epochs"]) == 1
        row = s["epochs"][0]
        assert row["steps"] == 4 and row["slowest_host"] == 0
        assert row["samples_per_sec_per_chip"] > 0
        assert 0 <= row["data_wait_pct"] < 100
        assert "epoch" in mod.render_table(s)
        out[name] = s
    assert set(out["port"]) == set(out["jax"])
    assert set(out["port"]["epochs"][0]) == set(out["jax"]["epochs"][0])


def test_registry_and_straggler_match_jax():
    port, ref = MetricsRegistry(), JaxRegistry()
    for reg in (port, ref):
        reg.inc("a")
        reg.inc("a", 2)
        reg.gauge("g", 3)
        for v in (0.5, 0.1, 0.3):
            reg.observe("t", v)
        with reg.timer("u"):
            pass
    a, b = port.snapshot(reset=True), ref.snapshot(reset=True)
    assert a["counters"] == b["counters"] and a["gauges"] == b["gauges"]
    assert a["timers"]["t"] == b["timers"]["t"]
    assert set(a["timers"]["u"]) == set(b["timers"]["u"])
    assert port.snapshot() == {"counters": {}, "gauges": {}, "timers": {}}
    steps, waits = [0.2, 0.4, 0.3], [0.01, 0.02, 0.0]
    assert epoch_straggler_stats(steps, waits) == jax_straggler(steps, waits)


def test_sink_rank_gated_and_append(tmp_path):
    inert = JsonlSink(str(tmp_path / "x"), process_index=1)
    inert.emit({"record": "step"})
    assert not inert.active and not (tmp_path / "x").exists()
    for _ in range(2):  # a restarted attempt appends to the same stream
        sink = JsonlSink(str(tmp_path))
        sink.emit({"record": "restart", "path": tmp_path})
        sink.close()
    recs = _records(str(tmp_path))
    assert [r["record"] for r in recs] == ["restart"] * 2
    assert all("ts" in r and r["path"] == str(tmp_path) for r in recs)


def test_log_format_json(capsys):
    logger = plog.get_logger("pdt_torch.test_json")
    try:
        plog.set_log_format("json")
        logger.info("hello %d", 3)
        line = capsys.readouterr().err.strip().splitlines()[-1]
        rec = json.loads(line)
        assert set(rec) == {"ts", "level", "logger", "process", "msg"}
        assert (rec["msg"], rec["level"], rec["process"]) == (
            "hello 3", "INFO", 0)
        with pytest.raises(ValueError, match="log format"):
            plog.set_log_format("xml")
    finally:
        plog.set_log_format("text")
        logging.getLogger("pdt_torch.test_json").handlers.clear()


_RANK_SCRIPT = """
import json, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="env://")
from pytorch_distributed_training_tpu_torch.telemetry.straggler import (
    epoch_straggler_stats)
r = dist.get_rank()
st = epoch_straggler_stats([r + 1.0] * 3, [0.5 * r] * 3,
                           group=dist.group.WORLD)
if r == 0:
    json.dump(st, open(sys.argv[1], "w"))
from pytorch_distributed_training_tpu_torch.cli import train_dp
train_dp.main(sys.argv[2:])  # joins the group above
"""


def test_straggler_named_over_two_gloo_ranks(tmp_path):
    # the gather over the batch group: rank 1 reports the slower steps and
    # is named, with its data wait; then a 2-rank train_dp run's epoch
    # record carries both ranks' stats in its stream
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    mdir = str(tmp_path / "m")
    argv = ["--model", "tiny", "--task", "synthetic", "--device", "cpu",
            "--train-size", "64", "--eval-size", "32",
            "--global-batch-size", "16", "--micro-batch-size", "4",
            "--num-epochs", "1", "--log-every", "0", "--max-seq-length",
            "32", "--metrics-dir", mdir]
    base = dict(os.environ, CUDA_VISIBLE_DEVICES="", MASTER_ADDR="127.0.0.1",
                MASTER_PORT=port, WORLD_SIZE="2", GLOO_SOCKET_IFNAME="lo",
                PYTHONPATH=REPO, PDT_TPU_FAULT="slow_host:3x@1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK_SCRIPT, str(tmp_path / "st"), *argv],
        cwd=REPO, env=dict(base, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=180)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    st = json.loads((tmp_path / "st").read_text())
    assert st == {
        "hosts": 2, "slowest_host": 1, "slowest_host_mean_step_s": 2.0,
        "fastest_host": 0, "fastest_host_mean_step_s": 1.0,
        "wait_skew_s": 1.0, "slowest_host_max_step_s": 2.0,
        "slowest_host_data_wait_mean_s": 0.5,
        "per_host_mean_step_s": [1.0, 2.0]}
    recs = _records(mdir)
    assert recs[0]["record"] == "run_meta" and recs[0]["rank"] == 0
    assert recs[0]["process_count"] == 2
    st = [r for r in recs if r["record"] == "epoch"][0]["straggler"]
    assert st["hosts"] == 2 and len(st["per_host_mean_step_s"]) == 2
    assert st["slowest_host"] == int(np.argmax(st["per_host_mean_step_s"]))
    assert st["wait_skew_s"] == pytest.approx(
        max(st["per_host_mean_step_s"]) - min(st["per_host_mean_step_s"]))
