"""Warm start: the kernel build directory + every library built before the
first step (counterpart: the JAX package's ``train/compile.py``).

JAX's two levers against cold-start latency map onto the port's builds:

- ``enable_persistent_cache(dir)`` (``TrainConfig.compile_cache_dir``)
  points the kernel libraries (``ops/_build``, ``nvcc``) and the native
  loader's (``native``, ``g++``) at ``dir``, keyed by their sources' and
  flags' hash, so a second run of the same code loads them instead of
  compiling; None keeps the package's ignored ``_build/``.
- ``warm_start(...)`` (``TrainConfig.aot_warmup``) builds, all at once,
  and loads every kernel library the run's model and options launch on
  its device (none on the CPU, where every wrapper takes its plain
  version), before epoch 0; the native loader's library, which the
  loaders build as the trainer makes them, counts as built when it was
  not in the directory before.
  The build's wall time moves out of the first step into its own
  ``compile`` telemetry record with JAX's fields: ``train_compile_s`` is
  the build and load, ``eval_compile_s`` 0 (the eval step launches the
  same libraries), ``cache_hit`` True when nothing had to be compiled
  (every library the run needs was in the directory; so also when it
  needs none), ``cache_entries`` the libraries in the directory after;
  ``libraries`` and ``built`` name them. No step changes: a run with the warm start
  gives the losses of one without.

A failed build raises with the compiler's output (``ops/_build.build``):
the first step would fail the same way.
"""

from __future__ import annotations

import os
import time

from pytorch_distributed_training_tpu_torch.ops import _build


def enable_persistent_cache(cache_dir: str | None) -> str:
    """Build and load the kernel and native libraries under ``cache_dir``
    (None: the package's ``_build/``); returns the directory in use, as
    an absolute path. Process-global, as JAX's cache."""
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
    return str(_build.set_build_dir(cache_dir or None))


def cache_entry_count(cache_dir: str | None) -> int | None:
    """Libraries on disk in ``cache_dir`` (None when no such directory)."""
    if not cache_dir or not os.path.isdir(cache_dir):
        return None
    return sum(1 for f in os.listdir(cache_dir) if f.endswith(".so"))


def kernel_libraries(model_config, device_type: str) -> list:
    """The kernel libraries a train run of ``model_config`` launches on a
    ``device_type`` device: the LayerNorm and dropout-add-LayerNorm
    kernels unless the plain LayerNorm is asked for, the dropout kernel,
    the flash kernels under flash or ring attention; none on the CPU."""
    if device_type != "cuda":
        return []
    libs = []
    if model_config.layernorm_impl != "reference":
        libs += ["layer_norm", "dropout_add_layer_norm"]
    libs.append("dropout")
    if model_config.attention_impl in ("flash", "ring"):
        libs.append("flash_attention")
    return libs


def warm_start(*, model_config, device_type: str, native_loader: bool,
               native_cached: bool, cache_dir: str) -> dict:
    """Build and load every kernel library of the run
    (``kernel_libraries``) before its first step; returns the ``compile``
    record. ``native_loader``: the run uses the native batch assembler,
    whose library was in the directory before the loaders were made when
    ``native_cached``."""
    libs = kernel_libraries(model_config, device_type)
    missing = [n for n in libs if not _build._lib_path(n).exists()]
    if native_loader and not native_cached:
        missing.append("batcher")
    t0 = time.perf_counter()
    _build.build(libs)
    for name in libs:
        _build.load(name)
    train_s = time.perf_counter() - t0
    return {
        "record": "compile",
        "aot": True,
        "train_compile_s": train_s,
        "eval_compile_s": 0.0,
        "compile_s": train_s,
        "cache_dir": cache_dir,
        "cache_hit": not missing,
        "cache_entries": cache_entry_count(cache_dir),
        "backend": device_type,
        "libraries": libs + (["batcher"] if native_loader else []),
        "built": missing,
    }
