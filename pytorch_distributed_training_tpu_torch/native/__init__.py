"""The port's host libraries in C++, loaded with ctypes (counterpart: the
JAX package's ``native/__init__.py``, whose declarations these are):

- ``src/batcher.cpp``: the prefetching batch assembler (a worker pool
  filling a ring of slots, ``data/native_loader.py``);
- ``src/wordpiece.cpp``: the multithreaded WordPiece batch encoder
  (``data/native_tokenizer.py``).

Each builds at first use with ``g++ -O3 -std=c++17 -shared -fPIC
-pthread`` into ``ops/_build.build_dir()`` (the ignored
``pytorch_distributed_training_tpu_torch/_build/`` by default), keyed
by a hash of the source and the flags, written under a temporary name and
renamed into place, so processes that build at once (test workers) never
load a half-written library. Nothing builds at import. Without a
toolchain (or when a build fails) the loaders return None and the
callers take their Python paths, or raise where the caller asked for the
library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

from pytorch_distributed_training_tpu_torch.ops import _build

SRC_DIR = Path(__file__).resolve().parent / "src"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL | None] = {}
#: library name -> why its build failed (the compiler's output)
BUILD_ERRORS: dict[str, str] = {}


def _forget() -> None:
    with _lock:
        _libs.clear()
        BUILD_ERRORS.clear()


_build.ON_DIR_CHANGE.append(_forget)


def __getattr__(name: str):
    if name == "BUILD_DIR":     # where the libraries build now
        return _build.build_dir()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update((SRC_DIR / f"{name}.cpp").read_bytes())
    return _build.build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def _compile(name: str) -> Path | None:
    out = lib_path(name)
    if out.exists():
        return out
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(SRC_DIR / f"{name}.cpp"), "-o", str(tmp)]
    try:
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True, text=True,
                       timeout=300)
        os.replace(tmp, out)
        _build.note_build()
    except subprocess.CalledProcessError as e:
        BUILD_ERRORS[name] = e.stderr or str(e)
        return None
    except (OSError, subprocess.SubprocessError) as e:
        BUILD_ERRORS[name] = f"{type(e).__name__}: {e}"
        return None
    finally:
        tmp.unlink(missing_ok=True)
    return out


def _load(name: str, declare) -> ctypes.CDLL | None:
    with _lock:
        if name in _libs:
            return _libs[name]
        _libs[name] = None
        path = _compile(name)
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            BUILD_ERRORS[name] = f"load failed: {e}"
            return None
        declare(lib)
        _libs[name] = lib
        return lib


def _declare_batcher(lib: ctypes.CDLL) -> None:
    lib.batcher_create.restype = ctypes.c_void_p
    lib.batcher_create.argtypes = [
        ctypes.POINTER(ctypes.c_void_p),  # const int32** arrays
        ctypes.POINTER(ctypes.c_int64),   # row_elems
        ctypes.c_int32,                   # n_arrays
        ctypes.c_int64,                   # n_rows
        ctypes.c_int64,                   # accum
        ctypes.c_int64,                   # micro_global
        ctypes.c_int64,                   # micro_local
        ctypes.c_int64,                   # local_off
        ctypes.c_int32,                   # n_slots
        ctypes.c_int32,                   # n_threads
    ]
    lib.batcher_start_epoch.restype = ctypes.c_int64
    lib.batcher_start_epoch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)
    ]
    lib.batcher_next.restype = ctypes.c_int32
    lib.batcher_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)
    ]
    lib.batcher_release.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.batcher_destroy.argtypes = [ctypes.c_void_p]


def _declare_wordpiece(lib: ctypes.CDLL) -> None:
    lib.wp_create.restype = ctypes.c_void_p
    lib.wp_create.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32]
    lib.wp_destroy.argtypes = [ctypes.c_void_p]
    lib.wp_special_id.restype = ctypes.c_int32
    lib.wp_special_id.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.wp_encode_pairs.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,                     # n
        ctypes.c_int64,                     # max_length
        ctypes.c_int32,                     # n_threads
        ctypes.POINTER(ctypes.c_int32),     # out_ids
        ctypes.POINTER(ctypes.c_int32),     # out_types
        ctypes.POINTER(ctypes.c_int32),     # out_mask
    ]


def load_batcher_lib() -> ctypes.CDLL | None:
    """Build (once) and load the batch assembler; None if unavailable."""
    return _load("batcher", _declare_batcher)


def load_wordpiece_lib() -> ctypes.CDLL | None:
    """Build (once) and load the WordPiece encoder; None if
    unavailable."""
    return _load("wordpiece", _declare_wordpiece)


def native_available() -> bool:
    return load_batcher_lib() is not None
