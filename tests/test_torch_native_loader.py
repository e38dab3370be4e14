"""Port parity, the C++ batch assembler (``data/native_loader.py``): the
port's native engine against JAX's ``ShardedLoader`` and JAX's
``NativeShardedLoader`` batch for batch, in train and eval (with
``valid``), at two ranks' slices and under the seq 2 column cut; batches
held past their ring slot's release keep their values; the library's
build, the engine's errors, and the trainer's engine choice, on the
CPU."""

import os
import time

import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.comms.mesh import build_mesh
from pytorch_distributed_training_tpu.data.native_loader import (
    NativeShardedLoader as JaxNativeShardedLoader,
)
from pytorch_distributed_training_tpu.data.pipeline import (
    ShardedLoader as JaxShardedLoader,
)
from pytorch_distributed_training_tpu import native as jax_native
from pytorch_distributed_training_tpu.native import (
    native_available as jax_native_available,
)
from pytorch_distributed_training_tpu.utils.config import MeshConfig
from pytorch_distributed_training_tpu_torch import native
from pytorch_distributed_training_tpu_torch.data.native_loader import (
    NativeShardedLoader,
)
from pytorch_distributed_training_tpu_torch.data.pipeline import ShardedLoader
from pytorch_distributed_training_tpu_torch.data.prefetch import (
    PrefetchingLoader,
)
from pytorch_distributed_training_tpu_torch.train.loop import Trainer
from pytorch_distributed_training_tpu_torch.train.step import lm_whole_rows
from pytorch_distributed_training_tpu_torch.utils.config import (
    TrainConfig,
    model_preset,
)

torch.set_num_threads(2)


def _dataset(n=64, seq=8, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "input_ids": rng.integers(0, 100, (n, seq)).astype(np.int32),
        "attention_mask": rng.integers(0, 2, (n, seq)).astype(np.int32),
        "token_type_ids": np.zeros((n, seq), np.int32),
        "labels": rng.integers(0, 2, n).astype(np.int32),
    }


def jax_native_lib(name: str) -> bool:
    """Whether JAX's native library ``name`` ("batcher" or "wordpiece")
    loads in this process. JAX's loader builds straight onto the final
    path and caches a failed load for the whole process, so a test worker
    that finds the file while another process's ``g++`` is still writing
    it sees no library. After a failed load: wait until the file stops
    changing (size and mtime the same 1 s apart, at most 120 s), drop the
    cached failure for that one name, and load again."""
    load = {"batcher": jax_native.load_batcher_lib,
            "wordpiece": jax_native.load_wordpiece_lib}[name]
    if load() is not None:
        return True
    path = os.path.join(jax_native._BUILD_DIR, f"lib{name}.so")
    deadline = time.monotonic() + 120.0
    seen = ()
    while time.monotonic() < deadline:
        try:
            st = os.stat(path)
            now = (st.st_size, st.st_mtime_ns)
        except FileNotFoundError:
            now = None
        if now == seen:
            break
        seen = now
        time.sleep(1.0)
    jax_native._libs.pop(name, None)
    return load() is not None


def test_library_builds_into_the_package_build_dir():
    assert native.native_available(), native.BUILD_ERRORS
    path = native.lib_path("batcher")
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.name.startswith("libbatcher-")
    assert native.load_wordpiece_lib() is not None, native.BUILD_ERRORS


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_native_engine_matches_jax_loaders_batch_for_batch(train,
                                                           eight_devices):
    # 44 rows: eval pads its last batch of 16 (12 valid); train drops the
    # ragged tail (2 steps of 16 at accumulation 2)
    assert jax_native_lib("batcher"), dict(jax_native._libs)
    assert jax_native_available()
    data = _dataset(n=44)
    kw = dict(global_batch_size=16, grad_accum_steps=2, train=train, seed=3)
    mesh = build_mesh(MeshConfig(data=8))
    refs = [JaxShardedLoader(data, mesh, **kw),
            JaxNativeShardedLoader(data, mesh, **kw)]
    one = NativeShardedLoader(data, **kw)
    two = [NativeShardedLoader(data, rank=r, world_size=2, **kw)
           for r in range(2)]
    assert {lo.steps_per_epoch for lo in (*refs, one, *two)} == {
        2 if train else 3}
    try:
        for epoch in (0, 1):
            rows = list(zip(*(lo.epoch(epoch) for lo in refs), one.epoch(
                epoch), *(t.epoch(epoch) for t in two)))
            assert len(rows) == one.steps_per_epoch
            for jp, jn, got, r0, r1 in rows:
                assert jp.keys() == jn.keys() == got.keys()
                for k in jp:
                    w = np.asarray(jp[k])
                    np.testing.assert_array_equal(np.asarray(jn[k]), w)
                    np.testing.assert_array_equal(got[k].numpy(), w)
                    axis = 1 if train and k != "valid" else 0
                    np.testing.assert_array_equal(np.concatenate(
                        [r0[k].numpy(), r1[k].numpy()], axis), w)
        if not train:
            assert rows[-1][2]["valid"].tolist() == [1] * 12 + [0] * 4
    finally:
        for lo in (refs[1], one, *two):
            lo.close()


def test_native_engine_equals_python_engine_under_the_seq_cut():
    # the seq 2 cut of every [.., batch, S] leaf, with the LM targets
    # shifted on the whole rows first, as the Python loader ships them
    data = _dataset(n=32, seq=8)
    for train in (True, False):
        for i in range(2):
            kw = dict(global_batch_size=8, grad_accum_steps=2, train=train,
                      seed=5, seq_index=i, seq_size=2,
                      whole_rows=lm_whole_rows)
            nat = NativeShardedLoader(data, **kw)
            for a, b in zip(nat.epoch(1), ShardedLoader(data, **kw).epoch(1),
                            strict=True):
                assert a.keys() == b.keys()
                for k in a:
                    assert a[k].dtype == b[k].dtype, k
                    assert torch.equal(a[k], b[k]), k
                assert a["input_ids"].shape[-1] == 4
            nat.close()


def test_batches_held_past_their_slot_release_keep_their_values():
    # four ring slots, each released as soon as its batch is shipped:
    # holding every batch of a 12-step epoch must not see the workers'
    # later fills, since each CPU batch is a copy of its slot
    data = _dataset(n=96)
    kw = dict(global_batch_size=8, grad_accum_steps=1, seed=11)
    nat = NativeShardedLoader(data, **kw)
    held = list(nat.epoch(0))
    want = list(ShardedLoader(data, **kw).epoch(0))
    assert len(held) == len(want) == 12
    for a, b in zip(held, want):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    # the same under prefetch, whose worker runs the engine ahead
    pre = PrefetchingLoader(NativeShardedLoader(data, **kw), depth=3)
    held = list(pre.epoch(0))
    for a, b in zip(held, want, strict=True):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    pre.close()
    nat.close()


def test_engine_errors_and_reuse_after_close():
    data = _dataset(n=16)
    with pytest.raises(TypeError, match="integer datasets only"):
        NativeShardedLoader(dict(data, x=np.zeros(16, np.float32)),
                            global_batch_size=8)
    nat = NativeShardedLoader(data, global_batch_size=8, seed=1)
    first = [b["input_ids"] for b in nat.epoch(0)]
    nat.close()
    nat.close()  # idempotent
    again = [b["input_ids"] for b in nat.epoch(0)]  # made anew
    assert all(torch.equal(a, b) for a, b in zip(first, again, strict=True))
    nat.close()


def _trainer(**kw):
    return Trainer(model_preset("tiny", compute_dtype="float32"),
                   TrainConfig(**dict(num_epochs=1, global_batch_size=16,
                                      micro_batch_size=8, eval_batch_size=16,
                                      train_size=32, eval_size=24,
                                      log_every=0, **kw)),
                   task="synthetic", device="cpu")


def test_trainer_engine_choice(monkeypatch):
    t = _trainer()
    assert isinstance(t.train_loader, PrefetchingLoader)
    assert isinstance(t.train_loader.inner, NativeShardedLoader)
    assert isinstance(t.eval_loader, NativeShardedLoader)
    t = _trainer(native_loader="off", prefetch_depth=0)
    assert type(t.train_loader) is ShardedLoader
    assert type(t.eval_loader) is ShardedLoader
    with pytest.raises(ValueError,
                       match="native_loader must be auto/on/off, got 'yes'"):
        _trainer(native_loader="yes")
    with pytest.raises(ValueError, match="prefetch_depth must be >= 0"):
        _trainer(prefetch_depth=-1)
    # no toolchain: "auto" takes the Python loader, "on" raises
    monkeypatch.setattr(native, "native_available", lambda: False)
    t = _trainer(prefetch_depth=0)
    assert type(t.train_loader) is ShardedLoader
    with pytest.raises(RuntimeError, match="C\\+\\+ batcher is unavailable"):
        _trainer(native_loader="on")


def test_trainer_eval_metrics_equal_under_either_engine():
    runs = {}
    for mode in ("on", "off"):
        runs[mode] = _trainer(native_loader=mode, prefetch_depth=0).run()
    for k in ("accuracy", "f1", "train_loss"):
        assert runs["on"][0][k] == runs["off"][0][k], k
