"""Continuous-batching inference (counterpart: the JAX package's
``serve/``): paged decode engine, admission queue, stdio front-end, and
the followers of a tensor-parallel replica."""

from pytorch_distributed_training_tpu_torch.serve.engine import (  # noqa: F401
    DecodeEngine,
    EngineConfig,
)
from pytorch_distributed_training_tpu_torch.serve.queue import (  # noqa: F401
    BackpressureError,
    GenRequest,
    RequestQueue,
)
from pytorch_distributed_training_tpu_torch.serve.server import (  # noqa: F401
    InferenceServer,
    serve_stdio,
)
from pytorch_distributed_training_tpu_torch.serve.tp_worker import (  # noqa: F401
    run_follower,
)
