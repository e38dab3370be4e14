"""Continuous-batching inference (counterpart: the JAX package's
``serve/``): paged decode engine, admission queue and brownout ladder,
prefix cache, stdio and HTTP front ends, live weight hot-swap, and the
followers of a tensor-parallel replica. The fleet, router, autoscaler and
traffic traces wait in ROADMAP.md (queue 1, item 7)."""

from pytorch_distributed_training_tpu_torch.serve.engine import (
    DecodeEngine,
    EngineConfig,
)
from pytorch_distributed_training_tpu_torch.serve.hotswap import (
    CheckpointWatcher,
    HotSwapManager,
    publish_params_checkpoint,
)
from pytorch_distributed_training_tpu_torch.serve.prefix_cache import (
    PrefixCache,
    PrefixMatch,
)
from pytorch_distributed_training_tpu_torch.serve.queue import (
    BackpressureError,
    BrownoutController,
    GenRequest,
    RequestQueue,
)
from pytorch_distributed_training_tpu_torch.serve.server import (
    InferenceServer,
    make_http_server,
    serve_stdio,
)
from pytorch_distributed_training_tpu_torch.serve.tp_worker import (
    run_follower,
)

__all__ = [
    "BackpressureError",
    "BrownoutController",
    "CheckpointWatcher",
    "DecodeEngine",
    "EngineConfig",
    "GenRequest",
    "HotSwapManager",
    "InferenceServer",
    "PrefixCache",
    "PrefixMatch",
    "RequestQueue",
    "make_http_server",
    "publish_params_checkpoint",
    "run_follower",
    "serve_stdio",
]
