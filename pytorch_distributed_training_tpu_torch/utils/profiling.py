"""Profiling and the NaN checks (counterpart: the JAX package's
``utils/profiling.py``).

- ``maybe_profile(trace_dir)`` runs ``torch.profiler`` (CPU activities,
  and CUDA's when a card is visible) over a region and writes its trace
  under ``trace_dir`` (``<host>_<pid>.<time>.pt.trace.json``, viewable in
  Perfetto or TensorBoard); at world size > 1 under
  ``trace_dir/host_<rank>``. A start that fails logs a warning and the
  region runs untraced, as in JAX.
- ``annotate(name)`` labels a region of the trace
  (``torch.profiler.record_function``).
- ``set_debug_nans(on)``: JAX's ``jax_debug_nans`` raises
  ``FloatingPointError`` at the first NaN a computation makes (NaN only,
  not inf). Here a forward hook on every module raises it at the first
  NaN in a module's output, naming the module's class, and
  ``check_grads`` (the train steps call it before the optimizer) at the
  first NaN in a gradient, naming the parameter. It is a debug mode: each
  check synchronizes with the device.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time

import torch

from pytorch_distributed_training_tpu_torch.utils.logging import (
    get_logger,
    log0,
)

_NAN_HOOK = None


def _trace_dir(trace_dir: str) -> str:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return os.path.join(trace_dir, f"host_{dist.get_rank()}")
    return trace_dir


@contextlib.contextmanager
def maybe_profile(trace_dir: str | None):
    if not trace_dir:
        yield
        return
    trace_dir = _trace_dir(trace_dir)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = None
    try:
        os.makedirs(trace_dir, exist_ok=True)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        log0(f"profiler trace started -> {trace_dir}")
    except Exception as e:  # noqa: BLE001
        # a failed start (an unwritable directory, a profiler already
        # running) must not end the run it was meant to observe
        prof = None
        get_logger().warning(
            "profiler trace failed to start (%s: %s); continuing untraced",
            type(e).__name__, e,
        )
    try:
        yield
    finally:
        if prof is not None:
            prof.stop()
            path = os.path.join(
                trace_dir, f"{socket.gethostname()}_{os.getpid()}."
                           f"{int(time.time() * 1000)}.pt.trace.json")
            prof.export_chrome_trace(path)
            log0(f"profiler trace written -> {path}")


def annotate(name: str):
    """Label a region in the profiler trace."""
    return torch.profiler.record_function(name)


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for o in out:
            yield from _tensors(o)
    elif isinstance(out, dict):
        for o in out.values():
            yield from _tensors(o)


def _nan_hook(module, inputs, output):
    for t in _tensors(output):
        if t.is_floating_point() and bool(torch.isnan(t).any()):
            raise FloatingPointError(
                f"NaN in the forward output of {module._get_name()}")


def set_debug_nans(enabled: bool) -> None:
    """Turn the NaN checks on or off for every module of the process."""
    global _NAN_HOOK
    if enabled and _NAN_HOOK is None:
        _NAN_HOOK = torch.nn.modules.module.register_module_forward_hook(
            _nan_hook)
    elif not enabled and _NAN_HOOK is not None:
        _NAN_HOOK.remove()
        _NAN_HOOK = None


def debug_nans() -> bool:
    return _NAN_HOOK is not None


def check_grads(module, params, grads) -> None:
    """With the NaN checks on, raise ``FloatingPointError`` naming the
    first parameter of ``params`` whose gradient in ``grads`` holds a
    NaN."""
    if _NAN_HOOK is None:
        return
    names = {id(p): n for n, p in module.named_parameters()}
    for p, g in zip(params, grads):
        if hasattr(g, "to_local"):  # an FSDP shard
            g = g.to_local()
        if g is not None and bool(torch.isnan(g).any()):
            raise FloatingPointError(
                f"NaN in the gradient of {names.get(id(p), '?')}")
