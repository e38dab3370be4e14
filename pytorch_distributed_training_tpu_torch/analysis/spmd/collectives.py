"""Collective recording + a simple link cost model (counterpart: the JAX
package's ``analysis/spmd/hlo.py``).

JAX's SPMD partitioner inserts collectives at compile time and its audit
reads them out of the compiled HLO text. The port issues its collectives
eagerly through ``torch.distributed`` (DDP's reducer and FSDP2 from C++
hooks and Python, tensor parallelism's all-reduces, the pipeline's
point-to-point), so in place of ``extract_collectives(hlo_text)`` it
records them: ``record_collectives()`` is a context that sees every
``c10d::`` op issued in its window, on the calling thread and on the
autograd threads its backward runs on (a ``TorchDispatchMode``: the
dispatcher routes the ``c10d`` ops through it wherever they are issued,
the C++ reducer's too), and lifts each into a :class:`Collective` with
JAX's kind, the bytes of its result, its dtype and its group's size. The
ops map onto JAX's kinds: ``allreduce_`` -> all-reduce (and
``broadcast_``, which XLA expresses as an all-reduce of one rank's
value), ``_allgather_base_``/``allgather_`` -> all-gather,
``_reduce_scatter_base_``/``reduce_scatter_`` -> reduce-scatter,
``alltoall_base_``/``alltoall_`` -> all-to-all, ``send``/``recv_`` ->
collective-permute. An op over a group of one rank moves nothing and is
left out, as a one-device JAX program holds no collective; barriers are
not data.

:class:`CostModel` and ``summarize_collectives`` are JAX's, unchanged:
bytes moved per device under ring algorithms, split by link class (ICI
within a host, DCN across hosts; NVLink and the network on a GPU host),
folded into the ``comm_audit`` record's shape. Consumers:
``analysis/spmd/manifest.py`` (``comm_audit``), the trainer's first step
and the serve engine's hot program after warm-up.

The recorder imports torch when entered; the rest is plain Python.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

#: canonical collective kinds, matching XLA's HLO opcode spellings
COLLECTIVE_KINDS = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective a recorded window issued."""

    name: str            # the c10d op and its place, e.g. "allreduce_.5"
    kind: str            # canonical kind (no -start suffix)
    dtype: str           # element type of the (first) result buffer
    bytes: int           # payload: result buffer size in bytes
    group_size: int      # ranks in the op's process group
    line: int            # 1-based place in the window
    asynchronous: bool   # issued with async_op


#: c10d op -> JAX's kind (ops not named here, barriers, are not recorded)
_OP_KINDS = {
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "broadcast_": "all-reduce",
    "reduce_": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "gather_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "scatter_": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute",
    "recv_": "collective-permute",
    "recv_any_source_": "collective-permute",
}

#: torch dtype -> JAX's HLO spelling
_HLO_DTYPES = {
    "bool": "pred", "uint8": "u8", "int8": "s8", "float16": "f16",
    "bfloat16": "bf16", "int16": "s16", "float32": "f32", "int32": "s32",
    "float64": "f64", "int64": "s64", "complex64": "c64",
    "complex128": "c128",
}


def _tensors(value) -> list:
    """The tensors in an op argument (a tensor, or nested lists of them)."""
    import torch

    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, (list, tuple)):
        return [t for v in value for t in _tensors(v)]
    return []


def _group_size(args) -> int:
    import torch.distributed as dist

    for a in args:
        if type(a).__name__ == "ScriptObject":
            try:
                return dist.ProcessGroup.unbox(a).size()
            except (RuntimeError, TypeError):
                continue
    return 0


def _collective(func, args, kwargs, line: int) -> Optional[Collective]:
    """The :class:`Collective` of one ``c10d::`` op call, or None (not a
    data collective, or a group of one rank)."""
    op = func._schema.name.split("::", 1)[1]
    kind = _OP_KINDS.get(op)
    if kind is None:
        return None
    group = _group_size(args)
    if group == 1:
        return None
    # the op's first argument is its result: the reduced tensors, the
    # gathered output, the scattered shard, the sent or received tensor
    result = _tensors(args[0]) if args else []
    if not result:
        return None
    named = dict(zip((a.name for a in func._schema.arguments), args))
    named.update(kwargs or {})
    return Collective(
        name=f"{op}.{line}",
        kind=kind,
        dtype=_HLO_DTYPES.get(str(result[0].dtype).replace("torch.", ""),
                              str(result[0].dtype)),
        bytes=int(sum(t.numel() * t.element_size() for t in result)),
        group_size=group,
        line=line,
        asynchronous=bool(named.get("async_op", named.get("asyncOp",
                                                          False))),
    )


_RECORDER = None


def _recorder_class():
    """The dispatch mode that records, made once."""
    global _RECORDER
    if _RECORDER is None:
        from torch.utils._python_dispatch import TorchDispatchMode

        class _Recorder(TorchDispatchMode):
            def __init__(self, seen: list):
                super().__init__()
                self.seen = seen

        def dispatch(self, func, types, args=(), kwargs=None):
            if func.namespace == "c10d":
                c = _collective(func, args, kwargs, len(self.seen) + 1)
                if c is not None:
                    self.seen.append(c)
            return func(*args, **(kwargs or {}))

        # set after the class is made: TorchDispatchMode wraps a subclass's
        # own __torch_dispatch__ in torch._disable_dynamo, whose first call
        # imports torch._dynamo (seconds); the recorder never runs under
        # dynamo
        _Recorder.__torch_dispatch__ = dispatch
        _RECORDER = _Recorder
    return _RECORDER


@contextlib.contextmanager
def record_collectives():
    """Record every collective issued in the window: yields the list the
    window's :class:`Collective` s are appended to, in issue order."""
    seen: list = []
    with _recorder_class()(seen):
        yield seen


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Ring-algorithm bytes-moved + wall-clock estimates per collective.

    Link classification is coarse on purpose: a replica group that fits
    inside one host rides ICI; anything wider pays DCN bandwidth. The
    point is relative footprint (does this program move param-sized or
    activation-sized traffic, and over which fabric), not a perf model.
    """

    ici_gbps: float = 90.0       # per-device intra-host bandwidth, GB/s
    dcn_gbps: float = 12.5       # per-device cross-host bandwidth, GB/s
    devices_per_host: int = 8

    def link(self, group_size: int) -> str:
        return "dcn" if group_size > self.devices_per_host else "ici"

    def moved_bytes(self, c: Collective) -> int:
        """Per-device bytes on the wire under ring algorithms.

        ``c.bytes`` is the RESULT buffer: the gathered size for
        all-gather, the scattered shard for reduce-scatter, the full
        buffer for all-reduce/all-to-all/permute.
        """
        g = max(c.group_size, 1)
        if g == 1:
            return 0
        if c.kind == "all-gather":
            return int(c.bytes * (g - 1) / g)
        if c.kind == "reduce-scatter":
            return int(c.bytes * (g - 1))          # input = result * g
        if c.kind == "all-reduce":
            return int(2 * c.bytes * (g - 1) / g)  # RS + AG
        if c.kind == "all-to-all":
            return int(c.bytes * (g - 1) / g)
        return int(c.bytes)                        # collective-permute

    def est_time_s(self, c: Collective) -> float:
        gbps = self.ici_gbps if self.link(c.group_size) == "ici" \
            else self.dcn_gbps
        return self.moved_bytes(c) / (gbps * 1e9)


def summarize_collectives(
    collectives, cost_model: Optional[CostModel] = None
) -> dict:
    """Fold extracted collectives into the ``comm_audit`` record shape."""
    cm = cost_model if cost_model is not None else CostModel()
    by_kind: dict = {}
    link_bytes = {"ici": 0, "dcn": 0}
    est_time_s = 0.0
    for c in collectives:
        slot = by_kind.setdefault(
            c.kind, {"count": 0, "bytes": 0, "moved_bytes": 0}
        )
        moved = cm.moved_bytes(c)
        slot["count"] += 1
        slot["bytes"] += c.bytes
        slot["moved_bytes"] += moved
        link_bytes[cm.link(c.group_size)] += moved
        est_time_s += cm.est_time_s(c)
    return {
        "count": len(collectives),
        "by_kind": by_kind,
        "total_bytes": sum(s["bytes"] for s in by_kind.values()),
        "total_moved_bytes": sum(
            s["moved_bytes"] for s in by_kind.values()
        ),
        "ici_moved_bytes": link_bytes["ici"],
        "dcn_moved_bytes": link_bytes["dcn"],
        "est_time_s": est_time_s,
    }
