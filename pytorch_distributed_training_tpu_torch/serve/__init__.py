"""Continuous-batching inference (counterpart: the JAX package's
``serve/``): paged decode engine, admission queue and brownout ladder,
prefix cache, stdio and HTTP front ends, live weight hot-swap, the
followers of a tensor-parallel replica, and the serving fleet — the
health-checked router (``router``), the supervised replica pool and its
rolling swap (``fleet``), the autoscaler (``autoscale``) and seeded
open-loop traffic traces (``trace``).

This ``__init__`` is lazy (PEP 562): the fleet's coordinator process
imports ``serve.router``/``serve.fleet`` and must not pay for torch and
the engine, which the names below pull in only when asked for."""

import importlib

_LAZY = {
    "BackpressureError": "queue",
    "BrownoutController": "queue",
    "CheckpointWatcher": "hotswap",
    "DecodeEngine": "engine",
    "EngineConfig": "engine",
    "GenRequest": "queue",
    "HotSwapManager": "hotswap",
    "InferenceServer": "server",
    "PrefixCache": "prefix_cache",
    "PrefixMatch": "prefix_cache",
    "RequestQueue": "queue",
    "make_http_server": "server",
    "publish_params_checkpoint": "hotswap",
    "run_follower": "tp_worker",
    "serve_stdio": "server",
}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    if name not in _LAZY:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    module = importlib.import_module(f"{__name__}.{_LAZY[name]}")
    return getattr(module, name)
