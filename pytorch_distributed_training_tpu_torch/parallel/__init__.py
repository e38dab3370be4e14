"""Parameter sharding and the pipeline schedules (counterpart: the JAX
package's ``parallel/``: ``sharding.py``, ``pipeline.py``)."""

from pytorch_distributed_training_tpu_torch.parallel.sharding import (
    ShardingPolicy,
    apply_fsdp,
    context_parallel,
    param_placements,
    param_specs,
    serve_param_specs,
    serve_pool_shape,
    tensor_parallel,
)

__all__ = ["ShardingPolicy", "apply_fsdp", "context_parallel",
           "param_placements", "param_specs", "serve_param_specs",
           "serve_pool_shape", "tensor_parallel"]
