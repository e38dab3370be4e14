"""Port parity, the warm start (``train/compile.py``): the ``compile``
record carries the fields of JAX's ``aot_warm_start`` record (read off a
JAX warm start of two small jitted steps), comes before the first step,
and a run with the warm start gives the losses, gradient norms and eval
metrics of one without, bit for bit; ``compile_cache_dir`` moves the
kernel and native builds (the native batch assembler builds there on the
first run, a cache hit on the second), and ``kernel_libraries`` names
the libraries a card run launches (none on the CPU)."""

import json

import jax
import jax.numpy as jnp
import pytest
from jax.sharding import PartitionSpec as P

from pytorch_distributed_training_tpu.comms.mesh import build_mesh
from pytorch_distributed_training_tpu.train import compile as jax_compile
from pytorch_distributed_training_tpu.utils.config import (
    MeshConfig as JaxMeshConfig,
)
from pytorch_distributed_training_tpu_torch import native
from pytorch_distributed_training_tpu_torch.ops import _build
from pytorch_distributed_training_tpu_torch.train.compile import (
    kernel_libraries,
)
from pytorch_distributed_training_tpu_torch.train.loop import Trainer
from pytorch_distributed_training_tpu_torch.utils.config import (
    TrainConfig,
    model_preset,
)


def _jax_record_keys(eight_devices):
    mesh = build_mesh(JaxMeshConfig(data=8))
    step = jax.jit(lambda s, b: s + b["x"].sum())
    spec = {"x": jax.ShapeDtypeStruct((8, 4), jnp.float32)}
    _, _, record = jax_compile.aot_warm_start(
        train_step=step, eval_step=step, state=jnp.zeros(()),
        train_spec=spec, eval_spec=spec, mesh=mesh, train_pspec=P("data"),
        eval_pspec=P("data"))
    return set(record)


def _run(tmp_path, name, **kw):
    cfg = dict(num_epochs=1, global_batch_size=16, micro_batch_size=8,
               eval_batch_size=16, learning_rate=3e-3, warmup_steps=2,
               log_every=0, bf16=False, train_size=48, eval_size=24,
               metrics_dir=str(tmp_path / name), prefetch_depth=0,
               native_loader="off")
    cfg.update(kw)
    t = Trainer(model_preset("tiny", compute_dtype="float32"),
                TrainConfig(**cfg), task="synthetic", device="cpu")
    history = t.run()
    with open(tmp_path / name / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f if line.strip()]
    return t, history, records


def test_compile_record_fields_and_same_losses(eight_devices, tmp_path):
    warm, whist, wrecs = _run(tmp_path, "warm", aot_warmup=True)
    cold, chist, crecs = _run(tmp_path, "cold", aot_warmup=False)
    kinds = [r["record"] for r in wrecs]
    (rec,) = [r for r in wrecs if r["record"] == "compile"]
    assert kinds.index("compile") < kinds.index("step")
    assert "compile" not in [r["record"] for r in crecs]
    # the sink stamps "ts" on every record; the port names its libraries
    jax_keys = _jax_record_keys(eight_devices)
    assert jax_keys <= set(rec)
    assert set(rec) - jax_keys == {"libraries", "built", "ts"}
    # on the CPU no kernel library builds: the wrappers take their plain
    # versions; the Python loader needs no native library
    assert (rec["aot"], rec["backend"], rec["libraries"], rec["built"],
            rec["cache_hit"], rec["eval_compile_s"]) == (
        True, "cpu", [], [], True, 0.0)
    assert rec["cache_dir"] == str(_build.build_dir())
    assert rec["compile_s"] == rec["train_compile_s"] >= 0.0
    # the same steps, bit for bit
    assert warm.step_log == cold.step_log
    assert [{k: v for k, v in h.items() if "per_sec" not in k}
            for h in whist] == [
        {k: v for k, v in h.items() if "per_sec" not in k} for h in chist]
    steps = [r for r in wrecs if r["record"] == "step"]
    assert [r["compile_inclusive"] for r in steps] == [False] * 3
    assert [r["compile_inclusive"] for r in crecs
            if r["record"] == "step"] == [True, False, False]


@pytest.fixture
def default_build_dir():
    yield
    _build.set_build_dir(None)


def test_compile_cache_dir_moves_the_builds(tmp_path, default_build_dir):
    if not native.native_available():
        pytest.skip("no C++ toolchain: the native loader cannot build")
    cache = tmp_path / "cache"
    _, _, first = _run(tmp_path, "a", native_loader="on",
                       compile_cache_dir=str(cache))
    assert _build.build_dir() == cache.resolve()
    assert native.lib_path("batcher").parent == cache.resolve()
    assert native.lib_path("batcher").exists()
    (rec,) = [r for r in first if r["record"] == "compile"]
    assert (rec["libraries"], rec["built"], rec["cache_hit"]) == (
        ["batcher"], ["batcher"], False)
    assert rec["cache_entries"] == 1 and rec["cache_dir"] == str(
        cache.resolve())
    _, _, second = _run(tmp_path, "b", native_loader="on",
                        compile_cache_dir=str(cache))
    (rec,) = [r for r in second if r["record"] == "compile"]
    assert (rec["built"], rec["cache_hit"], rec["cache_entries"]) == (
        [], True, 1)
    # None goes back to the package's _build/
    _run(tmp_path, "c", compile_cache_dir=None)
    assert _build.build_dir() == _build.DEFAULT_BUILD_DIR


def test_kernel_libraries_by_config():
    assert kernel_libraries(model_preset("tiny"), "cpu") == []
    assert kernel_libraries(model_preset("tiny"), "cuda") == [
        "layer_norm", "dropout_add_layer_norm", "dropout"]
    assert kernel_libraries(model_preset("gpt2-medium"), "cuda") == [
        "layer_norm", "dropout_add_layer_norm", "dropout", "flash_attention"]
    assert kernel_libraries(
        model_preset("tiny", layernorm_impl="reference",
                     attention_impl="ring"), "cuda") == [
        "dropout", "flash_attention"]
