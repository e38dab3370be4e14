"""Collectives of the trainer (counterpart: the JAX package's
``comms/collectives.py``, and the collectives GSPMD inserts for the branch
axis).

Each takes the process group of one mesh axis (``comms/mesh.py``); an axis
of one process has the group ``None``, and the collective is then the
identity. Data-parallel gradients need no call here: DDP all-reduces them
over the batch group, FSDP reduce-scatters those it shards; ``average_``
averages the rest (FSDP's replicated parameters) over the batch group.

- ``all_reduce_sum``/``all_reduce_mean``/``host_sum_counts``: small
  tensors summed or averaged over a group on this process's device (NCCL
  reduces CUDA tensors, gloo CPU ones): the step loss, the grad norm's
  squares, the eval counts.
- ``host_allgather``: a small float64 vector of every rank, to the host
  (the straggler stats, ``telemetry/straggler.py``).
- ``all_reduce_max``: the int8 sites' amaxes (``ops/quant.py``) maxed
  over every group the quantized tensor is cut over, in place: one scalar
  (or a weight's channels) a collective.
- ``reduce_from_model``/``copy_to_model``: the differentiable pair of the
  branch ensemble (Megatron's g and f). ``reduce_from_model`` sums its
  input over the group and passes the gradient through unchanged, since
  what consumes the sum (the head) runs replicated on every rank of the
  group and so already holds the whole gradient; ``copy_to_model`` passes
  its input through and sums the gradient over the group, so what feeds
  every rank's branches (the shared embeddings) gets the gradient of all
  of them. (``torch.distributed.nn.functional.all_reduce`` sums in its
  backward too, which would scale the branches' gradients by the group's
  size.)
- ``stage_send``/``stage_recv``: the activation of the layer split going
  forward to the next stage and its gradient coming back, as autograd
  Functions over ``dist.send``/``dist.recv``: ``stage_send`` sends its
  input and returns a scalar token whose backward receives the input's
  gradient; ``stage_recv`` receives the input of this stage and, in the
  backward, sends its gradient back. Tensors travel as a same-size integer
  view (gloo's point-to-point refuses bf16).
- ``exchange``: the pipeline schedules' point-to-point
  (``parallel/pipeline.py``): the sends and receives of one step of a
  schedule posted together (``dist.batch_isend_irecv``) and waited for,
  so a send of an activation and the receive of a gradient from the same
  neighbour pair up rather than block each other (NCCL's blocking pairs
  would deadlock, gloo's might); the same integer view on the wire.
  gloo sends and receives host tensors only, so a CUDA tensor under gloo
  (several processes sharing one card) goes through host memory, there
  and in ``stage_send``/``stage_recv``.
- ``ring_hop``: ring attention's hop (``ops/ring_attention.py``) over
  the ``seq`` axis, one ``exchange`` a step: K, V and the key-padding bias
  go to coordinate ``index - 1`` and arrive from ``index + 1``; in the
  backward K's and V's gradients travel the other way (JAX's transposed
  ``ppermute``).
- ``broadcast_first``: the one row that crosses the seq shards (BERT's
  CLS, on seq coordinate 0) broadcast to every seq rank; its backward sums
  the gradients over the axis into coordinate 0 (the transpose of a
  broadcast).
- ``broadcast_call``/``receive_call``: tensor-parallel serving's control
  channel (``serve/engine.py``, ``serve/tp_worker.py``; the JAX engine is
  one process under GSPMD and needs none): the leader, model coordinate 0,
  sends each device call to its followers before it runs the call itself,
  as a fixed header (the call's kind, a flag, each operand's dtype and
  shape) and one int64 buffer of the operands (token ids, positions,
  block-table rows, context lengths, page numbers: integers all). Two
  broadcasts a call over the model group, on the device under NCCL and on
  the host under gloo; ``all_ranks_ok``, the group's vote that a weight
  swap installs on every rank or none.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over ``group`` (a copy; ``t`` is left as it is)."""
    out = t.clone()
    if _size(group) > 1:
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def all_reduce_mean(t: torch.Tensor, group=None) -> torch.Tensor:
    """Mean of ``t`` over ``group``."""
    n = _size(group)
    return all_reduce_sum(t, group) / n if n > 1 else t.clone()


def all_reduce_max(t: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise max of ``t`` over ``group``, in place; ``t``. A
    no-op when the group is None or of one rank."""
    if _size(group) > 1:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t


def average_(tensors: list, group=None) -> None:
    """Average ``tensors`` over ``group`` in place, through one flat
    buffer (one all-reduce)."""
    if _size(group) == 1 or not tensors:
        return
    flat = torch._utils._flatten_dense_tensors(tensors)
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat /= _size(group)
    for t, avg in zip(tensors, torch._utils._unflatten_dense_tensors(
            flat, tensors)):
        t.copy_(avg)


def host_sum_counts(counts: dict[str, torch.Tensor],
                    groups=(None,)) -> dict[str, float]:
    """Sum a dict of scalar counts over each of ``groups`` in turn (one
    all-reduce a group) and bring the totals to the host."""
    keys = sorted(counts)
    total = torch.stack([counts[k].float() for k in keys])
    for group in groups:
        total = all_reduce_sum(total, group)
    return dict(zip(keys, total.cpu().tolist()))


def host_allgather(local: np.ndarray, group=None, device=None) -> np.ndarray:
    """``local`` (a small float64 vector) of every rank of ``group``, in
    rank order, stacked on the host: [ranks, len(local)]. NCCL gathers it
    on ``device`` (the process's card), gloo on the host."""
    local = np.asarray(local, np.float64)
    if _size(group) == 1:
        return local[None]
    if dist.get_backend(group) != dist.Backend.NCCL:
        device = "cpu"
    t = torch.as_tensor(local, device=device)
    parts = [torch.empty_like(t) for _ in range(_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.stack(parts).cpu().numpy()


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        dx = dy.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(dx, op=dist.ReduceOp.SUM, group=ctx.group)
        return dx, None


def reduce_from_model(x: torch.Tensor, group=None) -> torch.Tensor:
    """Forward: the sum of ``x`` over ``group``; backward: the identity."""
    return x if _size(group) == 1 else _ReduceFromModel.apply(x, group)


def copy_to_model(x: torch.Tensor, group=None) -> torch.Tensor:
    """Forward: the identity; backward: the gradient summed over
    ``group``."""
    return x if _size(group) == 1 else _CopyToModel.apply(x, group)


# integer dtypes by element size (bf16 and float32 activations): what goes
# over point-to-point
_WIRE = {2: torch.int16, 4: torch.int32}


def _wire(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().view(_WIRE[t.element_size()])


def _via_host(device, group=None) -> bool:
    """Whether a tensor on ``device`` travels point to point through host
    memory: a CUDA tensor under gloo."""
    return (torch.device(device).type == "cuda"
            and dist.get_backend(group) == "gloo")


def _send(t: torch.Tensor, dst: int) -> None:
    dist.send(_wire(t.cpu() if _via_host(t.device) else t), dst)


def _recv(shape, dtype, device, src: int) -> torch.Tensor:
    host = _via_host(device)
    buf = torch.empty(shape, dtype=dtype, device="cpu" if host else device)
    dist.recv(buf.view(_WIRE[buf.element_size()]), src)
    return buf.to(device) if host else buf


class _StageSend(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dst):
        ctx.meta = (x.shape, x.dtype, x.device, dst)
        _send(x, dst)
        return x.new_zeros((), dtype=torch.float32)

    @staticmethod
    def backward(ctx, _):
        return _recv(*ctx.meta), None


class _SendGradBack(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, src):
        ctx.src = src
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        _send(dy, ctx.src)
        return None, None


def stage_send(x: torch.Tensor, dst: int) -> torch.Tensor:
    """Send ``x`` to rank ``dst``; a scalar token whose ``backward()``
    receives ``x``'s gradient from ``dst`` and carries it on into ``x``."""
    return _StageSend.apply(x, dst)


def stage_recv(shape, dtype, device, src: int) -> torch.Tensor:
    """This stage's input, received from rank ``src``; under autograd its
    gradient is sent back to ``src`` in the backward."""
    x = _recv(shape, dtype, device, src)
    if not torch.is_grad_enabled():
        return x
    return _SendGradBack.apply(x.requires_grad_(), src)


def exchange(sends=(), recvs=(), group=None) -> list[torch.Tensor]:
    """Send each ``(tensor, dst)`` of ``sends`` and receive each ``(shape,
    dtype, device, src)`` of ``recvs`` (global ranks, over ``group``, None
    the default group), all posted in one batch and waited for; returns
    the received tensors in the order of ``recvs``."""
    ops = [dist.P2POp(dist.isend,
                      _wire(t.cpu() if _via_host(t.device, group) else t),
                      dst, group) for t, dst in sends]
    out, devices = [], []
    for shape, dtype, device, src in recvs:
        devices.append(device)
        out.append(torch.empty(shape, dtype=dtype, device="cpu" if _via_host(
            device, group) else device))
        ops.append(dist.P2POp(dist.irecv, _wire(out[-1]), src, group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return [t.to(device) for t, device in zip(out, devices)]


def _shift(tensors, shard, to: int, src: int) -> list[torch.Tensor]:
    """``tensors`` to seq coordinate ``to``, as many of the same shapes
    from ``src``, in one ``exchange`` over the axis's group."""
    return exchange(
        [(t, shard.rank(to)) for t in tensors],
        [(t.shape, t.dtype, t.device, shard.rank(src)) for t in tensors],
        shard.group)


class _RingHop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, k, v, *rest):
        ctx.shard, ctx.meta = shard, [(t.shape, t.dtype, t.device)
                                      for t in (k, v)]
        out = _shift((k, v) + rest, shard, shard.index - 1, shard.index + 1)
        ctx.mark_non_differentiable(*out[2:])
        return tuple(out)

    @staticmethod
    def backward(ctx, dk, dv, *_):
        shard = ctx.shard
        grads = [torch.zeros(shape, dtype=dtype, device=device)
                 if g is None else g
                 for g, (shape, dtype, device) in zip((dk, dv), ctx.meta)]
        dk, dv = _shift(grads, shard, shard.index + 1, shard.index - 1)
        return (None, dk, dv) + (None,) * len(_)


def ring_hop(k: torch.Tensor, v: torch.Tensor, bias=None, *, shard):
    """K, V and ``bias`` (None: none) one hop left along ``shard`` (an
    ``AxisShard`` of the seq axis): this rank's go to coordinate
    ``index - 1``, and those of ``index + 1`` come back; differentiable in
    K and V."""
    extra = () if bias is None else (bias,)
    out = _RingHop.apply(shard, k, v, *extra)
    return out[0], out[1], (out[2] if extra else None)


class _BroadcastFirst(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        out = x.detach().clone(memory_format=torch.contiguous_format)
        dist.broadcast(out, shard.rank(0), group=shard.group)
        return out

    @staticmethod
    def backward(ctx, dy):
        dx = dy.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(dx, op=dist.ReduceOp.SUM, group=ctx.shard.group)
        return (dx if ctx.shard.index == 0 else torch.zeros_like(dx)), None


def broadcast_first(x: torch.Tensor, shard=None) -> torch.Tensor:
    """Forward: coordinate 0's ``x`` on every rank of ``shard`` (an
    ``AxisShard``; None: ``x``); backward: the gradients summed over the
    axis, into coordinate 0 (zeros elsewhere)."""
    return x if shard is None else _BroadcastFirst.apply(x, shard)


# a call's header: kind, flag, operand count, then a dtype code, a rank
# and _CALL_DIMS dims for each of at most _CALL_OPERANDS operands
_CALL_OPERANDS = 6
_CALL_DIMS = 4
_CALL_HEADER = 3 + _CALL_OPERANDS * (2 + _CALL_DIMS)
_CALL_DTYPES = (np.dtype(np.int64), np.dtype(np.int32))


def _call_device(shard) -> torch.device:
    """Where the call's tensors travel: the card under NCCL, the host
    under gloo."""
    if dist.get_backend(shard.group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_call(shard, kind: int, operands=(), flag: int = 0) -> None:
    """Send one call (``kind``, ``flag`` and the integer numpy arrays
    ``operands``) from the model axis's coordinate 0 to every other rank
    of ``shard`` (its ``AxisShard``); a no-op without a group."""
    if shard is None or shard.group is None:
        return
    if len(operands) > _CALL_OPERANDS:
        raise ValueError(f"a call takes at most {_CALL_OPERANDS} operands, "
                         f"got {len(operands)}")
    header = np.zeros(_CALL_HEADER, np.int64)
    header[:3] = kind, flag, len(operands)
    for i, a in enumerate(operands):
        if a.dtype not in _CALL_DTYPES or a.ndim > _CALL_DIMS:
            raise ValueError(f"operand {i}: {a.dtype} of rank {a.ndim}")
        at = 3 + i * (2 + _CALL_DIMS)
        header[at:at + 2] = _CALL_DTYPES.index(a.dtype), a.ndim
        header[at + 2:at + 2 + a.ndim] = a.shape
    device, src = _call_device(shard), shard.rank(0)
    dist.broadcast(torch.from_numpy(header).to(device), src,
                   group=shard.group)
    if operands:
        payload = np.concatenate([a.astype(np.int64).reshape(-1)
                                  for a in operands])
        dist.broadcast(torch.from_numpy(payload).to(device), src,
                       group=shard.group)


def all_ranks_ok(shard, ok: bool) -> bool:
    """True when every rank of ``shard``'s group says ``ok`` (a MIN
    all-reduce on the call device); ``ok`` without a group."""
    if shard is None or shard.group is None:
        return ok
    flag = torch.tensor([int(ok)], device=_call_device(shard))
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=shard.group)
    return bool(flag.item())


def receive_call(shard) -> tuple[int, int, list]:
    """On a follower (model coordinate > 0): the next call of
    ``broadcast_call``, as ``(kind, flag, operands)``, the operands numpy
    arrays of their dtypes and shapes."""
    device, src = _call_device(shard), shard.rank(0)
    header = torch.empty(_CALL_HEADER, dtype=torch.int64, device=device)
    dist.broadcast(header, src, group=shard.group)
    header = header.cpu().numpy()
    kind, flag, count = (int(v) for v in header[:3])
    metas = []
    for i in range(count):
        at = 3 + i * (2 + _CALL_DIMS)
        code, ndim = (int(v) for v in header[at:at + 2])
        metas.append((_CALL_DTYPES[code],
                      tuple(int(d) for d in header[at + 2:at + 2 + ndim])))
    if not metas:
        return kind, flag, []
    payload = torch.empty(sum(math.prod(shape) for _, shape in metas),
                          dtype=torch.int64, device=device)
    dist.broadcast(payload, src, group=shard.group)
    flat, operands, at = payload.cpu().numpy(), [], 0
    for dtype, shape in metas:
        n = math.prod(shape)
        operands.append(flat[at:at + n].astype(dtype).reshape(shape))
        at += n
    return kind, flag, operands
