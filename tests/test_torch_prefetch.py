"""Port parity, prefetch (``data/prefetch.py``): the cases of the JAX
package's ``tests/test_prefetch.py`` on the port. The prefetched stream
equals the raw loader's under either engine, the queue stays bounded,
worker errors come in order, close() joins mid-epoch, a resumed epoch's
tail matches, a new epoch retires an abandoned iterator, the telemetry
adds up, and a Trainer's losses and parameters are bit-equal with
prefetch 0 and 2 and with the native engine on and off, on the CPU."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.comms.mesh import build_mesh
from pytorch_distributed_training_tpu.data.pipeline import (
    ShardedLoader as JaxShardedLoader,
)
from pytorch_distributed_training_tpu.data.prefetch import (
    PrefetchingLoader as JaxPrefetchingLoader,
)
from pytorch_distributed_training_tpu.utils.config import MeshConfig
from pytorch_distributed_training_tpu_torch.data.native_loader import (
    NativeShardedLoader,
)
from pytorch_distributed_training_tpu_torch.data.pipeline import ShardedLoader
from pytorch_distributed_training_tpu_torch.data.prefetch import (
    PrefetchingIterator,
    PrefetchingLoader,
)
from pytorch_distributed_training_tpu_torch.data.synthetic import (
    synthetic_pair_task,
)
from pytorch_distributed_training_tpu_torch.telemetry.registry import (
    MetricsRegistry,
    set_registry,
)
from pytorch_distributed_training_tpu_torch.train.loop import Trainer
from pytorch_distributed_training_tpu_torch.utils.config import (
    TrainConfig,
    model_preset,
)

torch.set_num_threads(2)

KW = dict(global_batch_size=32, grad_accum_steps=2, train=True)


def _materialize(batches):
    return [{k: v.clone() for k, v in b.items()} for b in batches]


def _assert_streams_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for k in x:
            assert torch.equal(x[k], y[k]), k


# ------------------------------------------------------------ the iterator


def test_bounded_queue_depth():
    pulled = []

    def src():
        for i in range(100):
            pulled.append(i)
            yield i

    it = PrefetchingIterator(src(), depth=3)
    assert [next(it) for _ in range(5)] == list(range(5))
    time.sleep(0.3)  # every chance to run ahead
    # consumed + the queue + at most one in the producer's hand
    assert len(pulled) <= 5 + 3 + 1
    it.close()


def test_worker_exception_propagates_in_order():
    def src():
        yield 1
        yield 2
        raise RuntimeError("boom in worker")

    it = PrefetchingIterator(src(), depth=2)
    assert next(it) == 1
    assert next(it) == 2
    with pytest.raises(RuntimeError, match="boom in worker"):
        next(it)
    with pytest.raises(StopIteration):  # finished, not wedged
        next(it)


def test_clean_close_midepoch_no_dangling_thread():
    finalized = []

    def src():
        try:
            for i in range(1000):
                yield i
        finally:
            finalized.append(threading.current_thread().name)

    it = PrefetchingIterator(src(), depth=2, name="t")
    assert next(it) == 0
    it.close()
    it._thread.join(timeout=5.0)
    assert not it._thread.is_alive()
    assert finalized == ["prefetch-t"]  # closed on the worker's thread
    with pytest.raises(StopIteration):
        next(it)
    it.close()  # idempotent


def test_depth_validation():
    with pytest.raises(ValueError, match="depth"):
        PrefetchingIterator(iter([]), depth=0)
    with pytest.raises(ValueError, match="depth"):
        PrefetchingLoader(object(), depth=0)


# ------------------------------------------------------------ the loaders


def test_stream_equivalent_to_python_loader_and_jax_prefetch(eight_devices):
    d = synthetic_pair_task(128, max_length=16, vocab_size=500)
    raw = ShardedLoader(d, **KW)
    wrapped = PrefetchingLoader(ShardedLoader(d, **KW), depth=2)
    jax_wrapped = JaxPrefetchingLoader(
        JaxShardedLoader(d, build_mesh(MeshConfig(data=8)), **KW), depth=2)
    assert wrapped.steps_per_epoch == raw.steps_per_epoch == 4
    for epoch in (0, 1):  # the same epoch seeds: the same batches, in order
        got = _materialize(wrapped.epoch(epoch))
        _assert_streams_equal(_materialize(raw.epoch(epoch)), got)
        _assert_streams_equal(got, [
            {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
            for b in jax_wrapped.epoch(epoch)])
    wrapped.close()
    jax_wrapped.close()


def test_stream_equivalent_to_native_loader():
    d = {"input_ids": np.arange(64 * 8, dtype=np.int32).reshape(64, 8),
         "labels": np.arange(64, dtype=np.int32)}
    kw = dict(global_batch_size=16, grad_accum_steps=2, seed=7)
    raw = NativeShardedLoader(d, **kw)
    wrapped = PrefetchingLoader(NativeShardedLoader(d, **kw), depth=3)
    try:
        _assert_streams_equal(_materialize(raw.epoch(0)),
                              _materialize(wrapped.epoch(0)))
    finally:
        raw.close()
        wrapped.close()


def test_resume_skip_prefix_matches():
    """A mid-epoch resume draws and drops the first ``skip`` batches; the
    rest is the raw stream's tail."""
    d = synthetic_pair_task(128, max_length=16, vocab_size=500)
    raw = ShardedLoader(d, **KW)
    wrapped = PrefetchingLoader(ShardedLoader(d, **KW), depth=2)
    tail = _materialize(raw.epoch(0))[2:]
    it = wrapped.epoch(0)
    for _ in range(2):
        next(it)
    _assert_streams_equal(tail, _materialize(it))
    wrapped.close()


def test_new_epoch_retires_abandoned_iterator():
    d = synthetic_pair_task(64, max_length=16, vocab_size=500)
    wrapped = PrefetchingLoader(
        ShardedLoader(d, global_batch_size=32, train=True), depth=2)
    first = wrapped.epoch(0)
    next(first)  # abandoned mid-epoch
    second = wrapped.epoch(1)
    assert not first._thread.is_alive()  # retired, not leaked
    assert len(_materialize(second)) == wrapped.steps_per_epoch
    wrapped.close()
    assert not second._thread.is_alive()


def test_prefetch_telemetry_occupancy_and_stalls():
    d = synthetic_pair_task(128, max_length=16, vocab_size=500)
    reg = MetricsRegistry()
    prev = set_registry(reg)
    try:
        wrapped = PrefetchingLoader(
            ShardedLoader(d, global_batch_size=32, train=True), depth=2)
        n = len(list(wrapped.epoch(0)))
        wrapped.close()
    finally:
        set_registry(prev)
    snap = reg.snapshot()
    occ = snap["timers"]["data/prefetch_occupancy"]
    assert occ["count"] == n
    assert 0.0 <= occ["max_s"] <= 2.0  # bounded by the depth
    stalls = snap["counters"].get("data/prefetch_stalls", 0)
    stall_t = snap["timers"].get("data/prefetch_stall_s", {"count": 0})
    assert stall_t.get("count", 0) == stalls


def test_proxies_the_inner_loader():
    d = synthetic_pair_task(64, max_length=16, vocab_size=500)
    inner = ShardedLoader(d, **KW)
    wrapped = PrefetchingLoader(inner, depth=2)
    assert (wrapped.steps_per_epoch, wrapped.accum) == (2, 2)
    a, b = wrapped.first_micro(16), inner.first_micro(16)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert wrapped.last_occupancy == 0 and wrapped.last_wait_s == 0.0
    wrapped.close()


# ------------------------------------------------------------ the trainer


def _tiny_trainer(**kw):
    cfg = dict(num_epochs=1, global_batch_size=32, micro_batch_size=16,
               eval_batch_size=32, learning_rate=3e-3, warmup_steps=10,
               log_every=0, bf16=False, train_size=128, eval_size=32)
    cfg.update(kw)
    return Trainer(model_preset("tiny", compute_dtype="float32"),
                   TrainConfig(**cfg), task="synthetic", device="cpu")


def test_trainer_wraps_train_loader_only():
    t = _tiny_trainer(prefetch_depth=2)
    assert isinstance(t.train_loader, PrefetchingLoader)
    assert not isinstance(t.eval_loader, PrefetchingLoader)
    t0 = _tiny_trainer(prefetch_depth=0)
    assert not isinstance(t0.train_loader, PrefetchingLoader)
    with pytest.raises(ValueError, match="prefetch_depth"):
        _tiny_trainer(prefetch_depth=-1)


@pytest.mark.parametrize("native", ["on", "off"])
def test_trainer_bitwise_equivalent_prefetch_on_off(tmp_path, native):
    """The same seeds: prefetch 2 and 0, on either engine, give the same
    per-step losses and final parameters, bit for bit, as the Python
    engine without prefetch; no thread outlives the run."""
    runs = {}
    before = threading.active_count()
    for name, kw in (("base", dict(prefetch_depth=0, native_loader="off")),
                     ("0", dict(prefetch_depth=0, native_loader=native)),
                     ("2", dict(prefetch_depth=2, native_loader=native))):
        mdir = str(tmp_path / name)
        t = _tiny_trainer(metrics_dir=mdir, **kw)
        t.run()
        with open(os.path.join(mdir, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f if line.strip()]
        losses = [r["loss"] for r in records if r.get("record") == "step"]
        params = torch.cat([p.detach().flatten()
                            for p in t.state.module.parameters()])
        runs[name] = (losses, params, records)
        del t
    for name in ("0", "2"):
        assert runs[name][0] == runs["base"][0]
        assert torch.equal(runs[name][1], runs["base"][1])
    steps = [r for r in runs["2"][2] if r.get("record") == "step"]
    assert all("prefetch_occupancy" in r for r in steps)
    assert threading.active_count() <= before
