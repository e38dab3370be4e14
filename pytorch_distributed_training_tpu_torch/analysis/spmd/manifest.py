"""Expected-collective manifests + the ``comm_audit`` runtime guard
(counterpart: the JAX package's ``analysis/spmd/manifest.py``, with its
formulas, record and counter).

A :class:`CommManifest` is a program's pinned communication contract:
which collective kinds it is allowed to contain, which it MUST contain,
and (optionally) a payload-bytes ceiling. ``comm_audit`` checks the
summary of a window's recorded collectives (``collectives.
record_collectives``, ``summarize_collectives``) against its manifest:
one ``comm_audit`` telemetry record, deviations counted, and
:class:`~pytorch_distributed_training_tpu_torch.analysis.guards.
GuardViolation` in strict mode. Record mode logs deviations without
failing — the rollout path new manifests go through before being pinned
strict. The trainer audits its first train step, the serve engine its hot program once after warm-up,
each rank its own ``_run`` window under ``tp`` (the leader's per-call
control broadcast is host control, outside the window, as JAX's HLO
audit sees only the device program).

Canonical manifests live here too: ``train_manifest(mesh)`` derives the
kinds a train step may legitimately emit from which mesh axes are
non-trivial (an fsdp mesh earns all-gather/reduce-scatter; a pipeline
mesh earns collective-permute; a 1-device mesh earns NOTHING), and
``serve_manifest(num_devices)`` pins the single-device serve programs
to zero collectives, and ``serve_tp_manifest`` the tensor-parallel
engine's all-reduces. The port's tensor-parallel serve rounds each
row-parallel partial to the compute dtype before its all-reduce, so its
``dtype_bytes`` is that dtype's size, the bytes on the wire.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from pytorch_distributed_training_tpu_torch.analysis.spmd.collectives import (
    COLLECTIVE_KINDS,
    Collective,
    CostModel,
    summarize_collectives,
)


@dataclasses.dataclass(frozen=True)
class CommManifest:
    """One program's expected-collective contract.

    ``allowed`` — kinds the program may contain (empty = zero
    collectives); ``required`` — kinds that must appear (catches the
    opposite regression: a "sharded" program that stopped communicating
    because everything got replicated); ``max_bytes`` — ceiling on total
    payload bytes across all collectives (e.g. a small multiple of param
    bytes for an fsdp step).
    """

    name: str
    allowed: tuple = ()
    required: tuple = ()
    max_bytes: Optional[int] = None
    # ceiling on ring-model bytes moved per device (CostModel.moved_bytes
    # summed over all collectives) — the wire-traffic twin of max_bytes
    max_moved_bytes: Optional[int] = None

    def __post_init__(self):
        for kind in tuple(self.allowed) + tuple(self.required):
            if kind not in COLLECTIVE_KINDS:
                raise ValueError(
                    f"manifest {self.name!r}: unknown collective kind "
                    f"{kind!r} (must be one of {COLLECTIVE_KINDS})"
                )

    def check(self, summary: dict) -> list:
        """Deviations of an extracted-collective summary from this
        manifest (empty list = conforming)."""
        deviations = []
        kinds = set(summary.get("by_kind", {}))
        allowed = set(self.allowed) | set(self.required)
        for kind in sorted(kinds - allowed):
            slot = summary["by_kind"][kind]
            deviations.append(
                f"unexpected {kind} x{slot['count']} "
                f"({slot['bytes']} payload bytes)"
            )
        for kind in self.required:
            if kind not in kinds:
                deviations.append(f"required {kind} absent")
        if (
            self.max_bytes is not None
            and summary.get("total_bytes", 0) > self.max_bytes
        ):
            deviations.append(
                f"total payload {summary['total_bytes']}B exceeds "
                f"manifest ceiling {self.max_bytes}B"
            )
        if (
            self.max_moved_bytes is not None
            and summary.get("total_moved_bytes", 0) > self.max_moved_bytes
        ):
            deviations.append(
                f"total moved {summary['total_moved_bytes']}B exceeds "
                f"manifest moved-bytes ceiling {self.max_moved_bytes}B"
            )
        return deviations

    def to_record(self) -> dict:
        return {
            "name": self.name,
            "allowed": list(self.allowed),
            "required": list(self.required),
            "max_bytes": self.max_bytes,
            "max_moved_bytes": self.max_moved_bytes,
        }


def train_manifest(mesh, *, max_bytes: Optional[int] = None,
                   name: str = "train_step",
                   fsdp_sharded: bool = False) -> CommManifest:
    """The kinds a train step may emit on this mesh. 1-device meshes pin
    zero collectives; a data axis earns gradient all-reduce; fsdp/model
    axes earn param all-gather + grad reduce-scatter (and all-to-all for
    tensor-parallel layouts); a stage axis earns pipeline permutes.

    ``fsdp_sharded=True`` (the mesh has an fsdp axis AND the sharding
    policy actually shards params over it) additionally REQUIRES an
    all-gather: sharded params must be gathered somewhere, so a step
    with none means everything silently ended up replicated — the
    de-sharding regression this manifest exists to catch."""
    shape = dict(mesh.shape)
    if max(shape.values(), default=1) <= 1:
        return CommManifest(name, allowed=(), max_bytes=max_bytes)
    allowed = ["all-reduce"]
    required = []
    if shape.get("fsdp", 1) > 1 or shape.get("model", 1) > 1:
        allowed += ["all-gather", "reduce-scatter"]
        if fsdp_sharded and shape.get("fsdp", 1) > 1:
            required += ["all-gather"]
    if shape.get("model", 1) > 1:
        allowed += ["all-to-all"]
    if shape.get("stage", 1) > 1:
        allowed += ["collective-permute"]
    return CommManifest(
        name, allowed=tuple(allowed), required=tuple(required),
        max_bytes=max_bytes,
    )


def serve_manifest(num_devices: int = 1,
                   name: str = "serve") -> CommManifest:
    """Serve programs on one device move nothing between chips — pinned.
    Multi-device serving (the sharded-replica roadmap item) starts from
    the full allowance and narrows per program as manifests get pinned."""
    if num_devices <= 1:
        return CommManifest(name, allowed=())
    return CommManifest(name, allowed=COLLECTIVE_KINDS)


def serve_tp_manifest(
    num_devices: int,
    *,
    layers: int,
    hidden: int,
    max_q_tokens: int,
    dtype_bytes: int = 4,
    name: str = "serve_tp",
    slack: float = 4.0,
    cost_model: Optional[CostModel] = None,
    weight_bytes_floor: Optional[int] = None,
) -> CommManifest:
    """The head-sharded serve engine's pinned contract: each layer's
    row-parallel attention-out and mlp_down matmuls combine their partial
    sums with exactly one all-reduce over the replicated ``[tokens,
    hidden]`` activation — so a program may contain ONLY all-reduces, MUST
    contain at least one (a "sharded" engine with none silently
    replicated its weights), and its total payload is bounded by ``2 *
    layers`` activation-sized reductions (slack absorbs dtype/fusion
    noise). An all-gather of weights is caught twice over: the kind is
    not allowed, and gathering even one projection would blow the
    activation-sized ceiling by orders of magnitude. ``max_q_tokens`` is
    the widest token block a dispatch scores — ``slots * (spec_k + 1)``
    for the verify program, ``slots`` for plain decode. The moved-bytes
    ceiling prices the same budget through the ring
    :class:`~pytorch_distributed_training_tpu_torch.analysis.spmd.
    collectives.CostModel`
    (2·B·(g−1)/g per all-reduce)."""
    # ``weight_bytes_floor`` makes the ceiling dtype-aware end to end: an
    # int8-weight replica passes the bytes of its SMALLEST sharded
    # projection, and the ceiling is clamped strictly below payload +
    # floor, so a program that all-reduced (or gathered) even one weight
    # matrix on top of its activations breaks the contract at its first
    # audit — slack can no longer mask a quantized engine silently
    # communicating fp32-sized (or any weight-sized) tensors.
    if num_devices <= 1:
        return CommManifest(name, allowed=())
    payload = 2 * layers * max_q_tokens * hidden * dtype_bytes
    max_bytes = int(slack * payload)
    if weight_bytes_floor is not None:
        max_bytes = min(max_bytes, payload + int(weight_bytes_floor) - 1)
    cm = cost_model if cost_model is not None else CostModel()
    moved = cm.moved_bytes(Collective(
        name=name, kind="all-reduce", dtype="f32", bytes=payload,
        group_size=num_devices, line=0, asynchronous=False,
    ))
    return CommManifest(
        name,
        allowed=("all-reduce",),
        required=("all-reduce",),
        max_bytes=max_bytes,
        max_moved_bytes=int(slack * moved),
    )


def comm_audit(
    name: str,
    summary: dict,
    manifest: CommManifest,
    *,
    registry=None,
    mode: str = "record",
) -> dict:
    """Audit a window's collective footprint against ``manifest``.

    ``summary`` is ``summarize_collectives`` of the window's recorded
    collectives. Emits one ``comm_audit`` record; deviations bump
    ``guards/comm_deviations`` and raise ``GuardViolation`` in strict
    mode.
    """
    from pytorch_distributed_training_tpu_torch.analysis.guards import (
        GuardViolation,
        _registry_or_default,
    )

    registry = _registry_or_default(registry)
    deviations = manifest.check(summary)
    record = {
        "record": "comm_audit",
        "name": name,
        "manifest": manifest.name,
        "ok": not deviations,
        "deviations": deviations,
        **summary,
    }
    registry.emit(record)
    if deviations:
        registry.inc("guards/comm_deviations", len(deviations))
        if mode == "strict":
            raise GuardViolation(
                f"comm audit {name!r}: the program deviates from "
                f"manifest {manifest.name!r}: {'; '.join(deviations)}"
            )
    return record
