"""Port parity, the collective audit (``analysis/spmd``): the manifests'
formulas (``train_manifest``, ``serve_manifest``, ``serve_tp_manifest``)
give JAX's ``to_record()`` for the same mesh shapes and sizes;
``CommManifest.check``, ``summarize_collectives`` and ``comm_audit`` give
JAX's deviations, summaries and records for the same collectives (JAX's
synthetic compiled-HLO dump, extracted by JAX and handed to both); the
tensor-parallel serve ceiling catches a gathered weight at the port's
bf16 wire width; the recorder sees DDP's all-reduce (issued from its C++
reducer), FSDP2's all-gather and reduce-scatter, broadcasts and
point-to-point over two gloo ranks, with their bytes, dtypes and group
sizes, and leaves groups of one rank out; and end to end on two gloo
ranks: an FSDP2 train step audits clean with its required all-gather,
and a ``serve_lm --tp 2`` engine audits its hot program clean on both
ranks. Every comparison is exact."""

import dataclasses
import io
import json
import os
import subprocess
import sys

import pytest
import torch

from pytorch_distributed_training_tpu.analysis import guards as jax_guards
from pytorch_distributed_training_tpu.analysis.spmd import hlo as jax_hlo
from pytorch_distributed_training_tpu.analysis.spmd import (
    manifest as jax_manifest,
)
from pytorch_distributed_training_tpu.telemetry.registry import (
    MetricsRegistry as JaxRegistry,
)
from pytorch_distributed_training_tpu_torch.analysis import spmd
from pytorch_distributed_training_tpu_torch.analysis.guards import (
    GuardViolation,
)
from pytorch_distributed_training_tpu_torch.telemetry.registry import (
    MetricsRegistry,
)
from pytorch_distributed_training_tpu_torch.utils.config import model_preset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# JAX's synthetic compiled-HLO dump (tests/test_spmd.py): an all-gather, an
# async all-reduce, a reduce-scatter over all devices and a bf16 permute
_HLO = """\
HloModule step

ENTRY %main {
  %all-gather.1 = f32[16,256]{1,0} all-gather(f32[2,256]{1,0} %p0), replica_groups={{0,1,2,3},{4,5,6,7}}, dimensions={0}
  %all-reduce-start.2 = (f32[128]{0}, f32[128]{0}) all-reduce-start(f32[128]{0} %p1), replica_groups=[2,4]<=[8], to_apply=%add
  %all-reduce-done.2 = f32[128]{0} all-reduce-done(%all-reduce-start.2)
  %reduce-scatter.3 = f32[32]{0} reduce-scatter(f32[256]{0} %p2), replica_groups={}, dimensions={0}, to_apply=%add
  %add.4 = f32[128]{0} add(f32[128]{0} %a, f32[128]{0} %b)
  ROOT %collective-permute.5 = bf16[64]{0} collective-permute(bf16[64]{0} %p3), source_target_pairs={{0,1},{1,2},{2,3},{3,0}}
}
"""


class _Shape:
    """mesh stand-in: the manifests only read ``mesh.shape``."""

    def __init__(self, **shape):
        self.shape = shape


class _Stage:
    def __init__(self, text):
        self._text = text

    def as_text(self):
        return self._text


class ListSink:
    def __init__(self):
        self.records = []

    def emit(self, record):
        self.records.append(dict(record))

    def flush(self, **kw):
        pass


def _port_collectives(jax_cs):
    return [spmd.Collective(**dataclasses.asdict(c)) for c in jax_cs]


MESHES = [dict(data=1), dict(data=8), dict(data=2, fsdp=4),
          dict(fsdp=8), dict(data=4, stage=2), dict(model=4),
          dict(data=2, fsdp=2, model=2), dict(data=2, stage=2, model=2),
          dict(data=1, fsdp=1, stage=1, model=1, seq=1)]


@pytest.mark.parametrize("fsdp_sharded", [False, True])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(
    f"{k}{v}" for k, v in s.items()))
def test_train_manifest_matches_jax(shape, fsdp_sharded):
    got = spmd.train_manifest(_Shape(**shape), fsdp_sharded=fsdp_sharded,
                              max_bytes=1 << 20)
    want = jax_manifest.train_manifest(
        _Shape(**shape), fsdp_sharded=fsdp_sharded, max_bytes=1 << 20)
    assert got.to_record() == want.to_record()


@pytest.mark.parametrize("n", [1, 2, 8])
def test_serve_manifests_match_jax(n):
    assert spmd.serve_manifest(n).to_record() == (
        jax_manifest.serve_manifest(n).to_record())
    for layers, hidden, q, dtype_bytes, slack, floor in (
            (24, 1024, 8, 2, 4.0, None), (24, 1024, 40, 2, 4.0, 1 << 20),
            (2, 64, 2, 4, 2.0, 64 * 64), (24, 1024, 8, 2, 4.0, 1024 ** 2)):
        kw = dict(layers=layers, hidden=hidden, max_q_tokens=q,
                  dtype_bytes=dtype_bytes, slack=slack,
                  weight_bytes_floor=floor)
        assert spmd.serve_tp_manifest(n, **kw).to_record() == (
            jax_manifest.serve_tp_manifest(n, **kw).to_record())


def test_summary_check_and_cost_model_match_jax():
    jax_cs = jax_hlo.extract_collectives(_HLO, world_size=8)
    cs = _port_collectives(jax_cs)
    assert spmd.summarize_collectives(cs) == (
        jax_hlo.summarize_collectives(jax_cs))
    cm, jcm = spmd.CostModel(), jax_hlo.CostModel()
    assert [cm.moved_bytes(c) for c in cs] == [
        jcm.moved_bytes(c) for c in jax_cs]
    summary = spmd.summarize_collectives(cs)
    for kw in (dict(allowed=("all-reduce",), required=("all-reduce",),
                    max_bytes=100),
               dict(allowed=spmd.COLLECTIVE_KINDS, required=("all-to-all",)),
               dict(allowed=("all-gather", "all-reduce", "reduce-scatter",
                             "collective-permute")),
               dict(allowed=spmd.COLLECTIVE_KINDS, max_moved_bytes=1000),
               dict()):
        got = spmd.CommManifest("m", **kw).check(summary)
        want = jax_manifest.CommManifest("m", **kw).check(summary)
        assert got == want
    with pytest.raises(ValueError, match="unknown collective kind"):
        spmd.CommManifest("bad", allowed=("all-gatherr",))


@pytest.mark.parametrize("mode", ["record", "strict"])
@pytest.mark.parametrize("manifest", ["conforming", "silent", "gathered"])
def test_comm_audit_records_counters_and_raises_match_jax(mode, manifest):
    kw = {"conforming": dict(allowed=("all-gather", "all-reduce",
                                      "reduce-scatter",
                                      "collective-permute")),
          "silent": dict(),
          "gathered": dict(allowed=spmd.COLLECTIVE_KINDS,
                           required=("all-to-all",))}[manifest]
    summary = spmd.summarize_collectives(_port_collectives(
        jax_hlo.extract_collectives(_HLO, world_size=8)))
    out = []
    for side in ("jax", "port"):
        reg = JaxRegistry() if side == "jax" else MetricsRegistry()
        sink = ListSink()
        reg.attach_sink(sink)
        try:
            if side == "jax":
                jax_manifest.comm_audit(
                    "step", _Stage(_HLO),
                    jax_manifest.CommManifest(manifest, **kw),
                    registry=reg, mode=mode, world_size=8)
            else:
                spmd.comm_audit("step", summary,
                                spmd.CommManifest(manifest, **kw),
                                registry=reg, mode=mode)
            raised = False
        except (GuardViolation, jax_guards.GuardViolation) as e:
            raised = "deviates from manifest" in str(e)
        out.append((sink.records, reg.snapshot()["counters"], raised))
    assert out[0] == out[1]
    assert out[1][2] == (mode == "strict" and manifest != "conforming")


def test_serve_tp_ceiling_catches_a_gathered_weight_at_bf16():
    """gpt2-medium's decode at tp 2 in bf16 on the wire: its 2 x 24
    activation all-reduces conform; one extra all-gathered or all-reduced
    attention-out weight (1024 x 1024 bf16) breaks the contract."""
    layers, hidden, slots = 24, 1024, 8
    m = spmd.serve_tp_manifest(2, layers=layers, hidden=hidden,
                               max_q_tokens=slots, dtype_bytes=2,
                               weight_bytes_floor=hidden * hidden * 2)

    def ar(nbytes, kind="all-reduce"):
        return spmd.Collective("c", kind, "bf16", nbytes, 2, 1, False)

    acts = [ar(slots * hidden * 2) for _ in range(2 * layers)]
    assert m.check(spmd.summarize_collectives(acts)) == []
    gathered = m.check(spmd.summarize_collectives(
        acts + [ar(hidden * hidden * 2, "all-gather")]))
    assert any("unexpected all-gather" in d for d in gathered)
    assert any("exceeds manifest ceiling" in d for d in gathered)
    reduced = m.check(spmd.summarize_collectives(
        acts + [ar(hidden * hidden * 2)]))
    assert any("exceeds manifest ceiling" in d for d in reduced)
    assert m.check(spmd.summarize_collectives([])) == [
        "required all-reduce absent"]


# -------------------------------------------- two gloo ranks, end to end

_CHILD = r"""
import json, os, sys
rank, port, root = int(sys.argv[1]), sys.argv[2], sys.argv[3]
os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                  MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
import torch, torch.distributed as dist
from pytorch_distributed_training_tpu_torch.analysis.spmd import (
    record_collectives)
from pytorch_distributed_training_tpu_torch.parallel import ShardingPolicy
from pytorch_distributed_training_tpu_torch.train.loop import Trainer
from pytorch_distributed_training_tpu_torch.utils.config import (
    MeshConfig, TrainConfig, model_preset)

out = {}
# an FSDP2 train run (fsdp 2) under strict guards: its first step audited
mdir = os.path.join(root, f"m{rank}")
t = Trainer(model_preset("tiny", compute_dtype="float32"),
            TrainConfig(num_epochs=1, global_batch_size=16,
                        micro_batch_size=8, eval_batch_size=16,
                        train_size=32, eval_size=16, log_every=0,
                        bf16=False, guards="strict", metrics_dir=mdir,
                        native_loader="off", prefetch_depth=0),
            task="synthetic", device="cpu",
            mesh_config=MeshConfig(data=1, fsdp=2),
            policy=ShardingPolicy(fsdp=True, fsdp_min_size=128))
t.run()
out["violations"] = t.guards.violations
# the recorder on its own: DDP (a second iteration, past its bucket
# rebuild), FSDP2, a broadcast, point-to-point and a one-rank group
m = torch.nn.Sequential(torch.nn.Linear(64, 64), torch.nn.Linear(64, 8))
ddp = torch.nn.parallel.DistributedDataParallel(m)
x = torch.randn(4, 64)
for _ in range(2):
    ddp(x).sum().backward()
with record_collectives() as ddp_seen:
    ddp(x).sum().backward()
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.fsdp import fully_shard
m2 = torch.nn.Sequential(torch.nn.Linear(64, 64), torch.nn.Linear(64, 8))
mesh = init_device_mesh("cpu", (2,))
for layer in m2:
    fully_shard(layer, mesh=mesh)
fully_shard(m2, mesh=mesh)
m2(x).sum().backward()
with record_collectives() as fsdp_seen:
    m2(x).sum().backward()
solo = [dist.new_group([r]) for r in range(2)]
with record_collectives() as misc_seen:
    dist.broadcast(torch.ones(3, dtype=torch.bfloat16), 0)
    if rank == 0:
        dist.send(torch.ones(5), 1)
    else:
        dist.recv(torch.empty(5), 0)
    dist.all_reduce(torch.ones(7), group=solo[rank])
def rows(seen):
    return [(c.kind, c.dtype, c.bytes, c.group_size) for c in seen]
out.update(ddp=rows(ddp_seen), fsdp=rows(fsdp_seen), misc=rows(misc_seen))
json.dump(out, open(os.path.join(root, f"out{rank}.json"), "w"))
dist.destroy_process_group()
"""


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _two_ranks(code, tmp_path, extra=()):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo", JAX_PLATFORMS="cpu")
    env.pop("PDT_TPU_GUARDS", None)
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), port,
                               str(tmp_path), *extra], env=env, cwd=REPO,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs[0][-3000:] + (
        outs[1][-3000:])
    return outs


def test_recorder_and_fsdp2_train_audit_over_two_gloo_ranks(tmp_path):
    _two_ranks(_CHILD, tmp_path)
    res = [json.load(open(tmp_path / f"out{r}.json")) for r in range(2)]
    for r, out in enumerate(res):
        assert out["violations"] == 0
        # DDP's reducer: one bucket, every gradient, from its C++ hook
        assert out["ddp"] == [["all-reduce", "f32", 4 * 4680, 2]]
        # FSDP2: a per-layer all-gather of the flat shards forward and
        # backward, a reduce-scatter of each layer's gradients
        assert out["fsdp"] == [
            ["all-gather", "f32", 4 * 4160, 2],
            ["all-gather", "f32", 4 * 520, 2],
            ["all-gather", "f32", 4 * 520, 2],
            ["all-gather", "f32", 4 * 4160, 2],
            ["reduce-scatter", "f32", 4 * 260, 2],
            ["reduce-scatter", "f32", 4 * 2080, 2]]
        # a broadcast is JAX's all-reduce of one rank's value; send and
        # recv the permute's halves; the one-rank group left out
        assert out["misc"] == [["all-reduce", "bf16", 6, 2],
                               ["collective-permute", "f32", 20, 2]]
    with open(tmp_path / "m0" / "metrics.jsonl") as f:   # rank 0 writes
        records = [json.loads(line) for line in f if line.strip()]
    (audit,) = [x for x in records if x["record"] == "comm_audit"]
    assert audit["ok"] and audit["manifest"] == "train_step"
    assert set(audit["by_kind"]) >= {"all-gather", "reduce-scatter"}
    (shard,) = [x for x in records if x["record"] == "sharding_audit"]
    assert shard["ok"]


_SERVE_TP = r"""
import io, json, os, sys
rank, port, root = int(sys.argv[1]), sys.argv[2], sys.argv[3]
os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                  MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
from pytorch_distributed_training_tpu_torch.cli import serve_lm
lines = "".join(json.dumps({"id": f"r{i}", "prompt": "hello " * (i + 2),
                            "max_new_tokens": 6}) + "\n" for i in range(3))
out = io.StringIO()
stats = serve_lm.main(["--model", "gpt2-tiny", "--device", "cpu", "--tp",
                       "2", "--num-slots", "2", "--prompt-buckets", "16,32",
                       "--max-new-tokens-cap", "16", "--warmup"],
                      in_stream=io.StringIO(lines if rank == 0 else ""),
                      out_stream=out)
json.dump({"stats": stats, "events": out.getvalue()},
          open(os.path.join(root, f"serve{rank}.json"), "w"))
"""


def test_serve_tp2_hot_program_audit_on_both_ranks(tmp_path):
    """``serve_lm --tp 2 --warmup`` on gpt2-tiny over gloo: each rank's
    audit of the decode step's ``_run`` window holds exactly its 2 x
    layers activation all-reduces ([slots, 1, hidden] in the compute
    dtype), clean against ``serve_tp_manifest``; the streams finish; the
    follower ran every call the leader dispatched, warm-up included."""
    _two_ranks(_SERVE_TP, tmp_path)
    leader, follower = (json.load(open(tmp_path / f"serve{r}.json"))
                        for r in range(2))
    events = [json.loads(x) for x in leader["events"].splitlines()]
    assert sum(e["event"] == "done" for e in events) == 3
    cfg = model_preset("gpt2-tiny")
    # 2 layers x 2 row-parallel sums, each [2 slots, 1, 64] in the compute
    # dtype; at 2 ranks a ring all-reduce moves its bytes once
    nbytes = 2 * 2 * (2 * 1 * 64) * getattr(torch, cfg.compute_dtype).itemsize
    for stats in (leader["stats"], follower["stats"]):
        audit = stats["comm_audit"]
        assert audit["ok"] and audit["manifest"] == "serve_decode"
        assert audit["by_kind"] == {"all-reduce": {
            "count": 2 * 2, "bytes": nbytes, "moved_bytes": nbytes}}
    s = leader["stats"]
    assert (s["guard_mode"], s["guard_recompiles"],
            s["guard_implicit_transfers"]) == ("strict", 0, 0)
    assert follower["stats"]["calls"] == (
        s["prefill_dispatches"] + s["decode_dispatches"]
        + sum(s["warmup_dispatches"].values()))
