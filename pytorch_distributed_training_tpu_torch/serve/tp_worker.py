"""Tensor-parallel serving's followers (counterpart: the device half of the
JAX package's ``serve/engine.py`` under ``tp > 1``, where one process
drives the ``model`` axis's devices under GSPMD).

A replica of ``tp`` ranks is the leader, rank 0's ``DecodeEngine``, and a
follower on every other rank of the model group. ``run_follower`` builds
the same served slice and pools as the leader, from the same model and
``EngineConfig`` (``serve/engine.ServeSlice``: cast for serving, int8
quantized whole, then cut to this rank's heads and MLP columns, pools at
``heads / tp``; the draft model's slice and pools too under
``spec_draft="model"``), then loops: receive a device call from the leader
(``comms/collectives.receive_call``), run it on its slice and pools,
repeat. It makes no host decision: admission, deadlines, sampling,
speculation's acceptance and eviction are the leader's, so clocks cannot
make the ranks part. The draft lane's chain of greedy decodes is one call:
every rank runs it whole, feeding its own argmax forward, which the
all-reduced logits make the same on every rank. A follower runs each forward whole, the replicated
tied head included, and drops its logits: it joins every row-parallel
all-reduce, and every rank launches the same kernels. A weight swap is
a call too (``ServeSlice._follow_swap``): each follower loads the step
from the checkpoint directory the leader names, cuts its own slice, and
the model group votes, so the swap installs on every rank or none; the
swap's end commits it or copies the previous weights back. The stop
message (``DecodeEngine.shutdown``) ends the loop.
"""

from __future__ import annotations

import torch

from pytorch_distributed_training_tpu_torch.comms.collectives import (
    receive_call,
)
from pytorch_distributed_training_tpu_torch.serve.engine import (
    CALL_STOP,
    EngineConfig,
    ServeSlice,
)


class TPFollower(ServeSlice):
    """One follower: this rank's slice and pools, and the loop that runs
    the leader's calls on them (``shard``: the model axis's
    ``AxisShard``, this rank at a coordinate above 0)."""

    def __init__(self, model, config: EngineConfig, *, device="cuda",
                 shard, draft_model=None):
        super().__init__(model, config, device=device, shard=shard,
                         draft_model=draft_model)
        self.calls = 0

    def run(self) -> int:
        """Run the leader's calls until its stop message; the calls run."""
        with torch.inference_mode():
            while True:
                kind, flag, operands = receive_call(self._shard)
                if kind == CALL_STOP:
                    return self.calls
                self._run(kind, operands, flag)
                self.calls += 1

    def stats(self) -> dict:
        """This rank's part: its calls, slice bytes and pools."""
        return {
            "device": str(self.device),
            "tp": self.config.tp,
            "rank": self._shard.index,
            "calls": self.calls,
            "variant": self.variant,
            "weight_bytes": self.weight_bytes,
            "kv_bytes_per_token": self._kv_bytes_per_token(),
            "kv_heads": self._kv_heads(),
        }


def run_follower(model, config: EngineConfig, *, device="cuda",
                 shard, draft_model=None) -> dict:
    """Build this rank's follower (with the draft lane's model under
    ``spec_draft="model"``) and run it until the leader's stop message;
    its ``stats()``."""
    follower = TPFollower(model, config, device=device, shard=shard,
                          draft_model=draft_model)
    follower.run()
    return follower.stats()
