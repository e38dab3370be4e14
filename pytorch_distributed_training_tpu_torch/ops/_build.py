"""Build and load the port's CUDA kernels (no JAX counterpart).

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library under
``pytorch_distributed_training_tpu_torch/_build/``, loaded with
``ctypes``. The sources include no PyTorch header, so a build takes
seconds; pointers and the stream travel as integers.

Build at first use: nothing here runs at import, so the package imports
on a machine with no ``nvcc`` (the CPU tests import every module). A
failed build raises with the compiler's output; nothing falls back.
``build()`` compiles several sources at once, one ``nvcc`` process each,
all started together.

A library may hold several kernels (``KERNELS`` names each kernel's
library): the LayerNorm forward and backward share ``layer_norm.cu``, the
four flash-attention kernels ``flash_attention.cu``.

Launch counts: every kernel wrapper adds one to ``LAUNCH_COUNTS[name]``
where it launches its kernel and nowhere else, so a run can show that the
main path went through the kernel (the counterpart of the JAX package's
``ops/dispatch.KERNEL_DISPATCH_COUNTS``).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

#: library name -> CUDA source under csrc/
KERNEL_SOURCES = {
    "layer_norm": "layer_norm.cu",
    "dropout_add_layer_norm": "dropout_add_layer_norm.cu",
    "dropout": "dropout.cu",
    "paged_attention": "paged_attention.cu",
    "flash_attention": "flash_attention.cu",
}

#: kernel (the name its launches are counted under) -> library holding it
KERNELS = {
    "layer_norm": "layer_norm",
    "layer_norm_bwd": "layer_norm",
    "dropout_add_layer_norm": "dropout_add_layer_norm",
    "dropout_add_layer_norm_bwd": "dropout_add_layer_norm",
    "mask_scale": "dropout",
    "paged_attention": "paged_attention",
    "flash_fwd": "flash_attention",
    "flash_bwd": "flash_attention",
    "flash_whole_fwd": "flash_attention",
    "flash_whole_bwd": "flash_attention",
}

NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xptxas=-v",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

#: kernel name -> launches since the last reset
LAUNCH_COUNTS: collections.Counter = collections.Counter()

#: kernel name -> the compiler's output of the build that made the library
BUILD_LOGS: dict[str, str] = {}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    LAUNCH_COUNTS.clear()


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built on this machine"
        )
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC_DIR / KERNEL_SOURCES[name]).read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    key = h.hexdigest()
    return BUILD_DIR / f"lib{name}-{key[:16]}.so"


def build(names=None) -> dict[str, float]:
    """Compile the named kernels (default: all) that are not built yet, one
    ``nvcc`` per source, all at once. Returns seconds per name built;
    raises ``RuntimeError`` with the compiler output on any failure."""
    names = list(KERNEL_SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = _lib_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / KERNEL_SOURCES[n])]
        procs[n] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, out)
    seconds = {}
    errors = []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[n] = time.perf_counter() - t0
        BUILD_LOGS[n] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {KERNEL_SOURCES[n]} "
                          f"(exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            lib.pdt_cuda_error_string.argtypes = [ctypes.c_int]
            lib.pdt_cuda_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def check_launch(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise when a launch returned a CUDA error (``cudaGetLastError``
    right after the launch: a refused launch never runs, and a later
    synchronize would not report it)."""
    if name not in KERNELS:
        raise KeyError(f"unknown kernel {name!r}; have {sorted(KERNELS)}")
    if code != 0:
        msg = lib.pdt_cuda_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (code {code})")
    LAUNCH_COUNTS[name] += 1


def stream_ptr(tensor) -> int:
    """PyTorch's current CUDA stream on ``tensor``'s device, as an int."""
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream
