"""Serving entry point: continuous-batching LM inference over stdio JSONL
(counterpart: the JAX package's ``cli/serve_lm.py``).

    echo '{"prompt": "The quick brown", "max_new_tokens": 16}' | \\
    python -m pytorch_distributed_training_tpu_torch.cli.serve_lm \\
        --model gpt2-medium --num-slots 8

Runs on the GPU (``--device cuda``, the default; it raises when no GPU is
visible and never carries on quietly on the CPU) or on the CPU with
``--device cpu``, where every kernel takes its plain PyTorch version.
Engine knobs as in the JAX package: ``--num-slots`` fixed decode slots,
``--prompt-buckets`` prefill lengths, ``--max-new-tokens-cap`` bounds the
KV cache (largest bucket + cap), ``--page-size``/``--num-pages`` size the
paged KV pool, ``--queue-depth`` backpressure, ``--deadline-s`` default
deadline. Serving options: ``--spec-k`` speculative decoding (n-gram
drafts, or a draft model's with ``--draft-checkpoint DIR --draft-model
PRESET``, loaded as the base model is), ``--prefill-chunk`` and
``--prefill-concurrency`` chunked prefill, ``--prefix-cache`` the
shared-KV prefix cache (``--tenant-page-quota F``: a tenant's private
pages capped at a fraction of the pool; request lines carry ``tenant``
and ``tier``), ``--weights-dtype int8`` weight-only int8 projections
(quantized after loading), ``--kv-dtype int8`` int8 KV pools,
``--kv-layout dense`` the dense per-slot cache and ``--sampling host``
host-side sampling (the plain baselines). Weights: ``--checkpoint-dir`` (a trainer checkpoint, the
newest verified step; the engine reports it as ``stats()["weights_step"]``),
``--hf-checkpoint`` or random from ``--seed`` (``cli/generate_lm.py``'s
``load_model_and_params``). Events go to stdout, logs to stderr.

``--tp N`` serves one replica over N processes, one a card, launched by
``torch.distributed.run`` (NCCL on cards, gloo with ``--device cpu``)::

    python -m torch.distributed.run --nproc-per-node 2 \\
        -m pytorch_distributed_training_tpu_torch.cli.serve_lm \\
        --model gpt2-medium --tp 2 < requests.jsonl

``--tp`` must equal the world size. Every rank builds the whole model from the
same ``--seed`` (or loads the same checkpoint) and cuts its slice; rank 0, the leader, reads the requests on stdin and
writes the events, and the other ranks run their slice of every device
call (``serve/tp_worker.py``). Every rank exits 0 at EOF.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    from pytorch_distributed_training_tpu_torch.cli.generate_lm import (
        add_model_args,
    )

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_model_args(p)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the engine runs (cuda raises when no GPU is "
                        "visible)")
    p.add_argument("--num-slots", type=int, default=4,
                   help="fixed decode slots (concurrent in-flight requests)")
    p.add_argument("--prompt-buckets", default="16,32,64,128",
                   help="comma-separated prompt-length buckets; prompts pad "
                        "up to the smallest that fits")
    p.add_argument("--max-new-tokens-cap", type=int, default=64,
                   help="per-request max_new_tokens ceiling; KV cache length "
                        "= largest bucket + this cap")
    p.add_argument("--queue-depth", type=int, default=16,
                   help="admission-queue depth; submissions beyond it are "
                        "rejected with a backpressure error")
    p.add_argument("--kv-layout", default="paged",
                   choices=("paged", "dense"),
                   help="KV-cache layout: paged (block-table pages, "
                        "page-budget admission) or dense (one [slots, "
                        "cache_len] buffer, the plain baseline)")
    p.add_argument("--page-size", type=int, default=16,
                   help="tokens per KV page")
    p.add_argument("--num-pages", type=int, default=0,
                   help="total KV pages incl. the reserved null page (0 = "
                        "auto-size so every slot fits a worst-case request)")
    p.add_argument("--sampling", default="device",
                   choices=("device", "host"),
                   help="token selection: device ([slots] token ids to "
                        "the host a tick) or host (float32 logits to the "
                        "host, sampled in numpy: the reference path)")
    p.add_argument("--spec-k", type=int, default=0,
                   help="speculative decoding: draft tokens proposed per "
                        "slot per tick (0 = off); each verify dispatch "
                        "scores k+1 positions and commits every accepted "
                        "one — same token stream, fewer dispatches; drafts "
                        "come from the n-gram (prompt-lookup) drafter, or "
                        "from --draft-checkpoint's model")
    p.add_argument("--draft-checkpoint", default=None,
                   help="trainer checkpoint dir of a small DRAFT model that "
                        "proposes the speculative tokens (its newest "
                        "verified step); without it --spec-k uses the "
                        "n-gram drafter")
    p.add_argument("--draft-model", default="gpt2-tiny",
                   help="model preset of --draft-checkpoint (its vocab "
                        "must match the base model's)")
    p.add_argument("--prefill-chunk", type=int, default=0,
                   help="chunked prefill: stream prompts into the paged KV "
                        "cache this many tokens per tick (0 = one prefill "
                        "per bucket); long prompts stop monopolising the "
                        "tick loop")
    p.add_argument("--prefill-concurrency", type=int, default=1,
                   help="slots streaming a chunked prompt at once; further "
                        "admissions wait a tick (a hold, not page "
                        "exhaustion)")
    p.add_argument("--prefix-cache", action="store_true",
                   help="shared-KV prefix cache: finished prompts' pages "
                        "are indexed in a token-keyed trie and a matching "
                        "prompt prefix is served from the cache (refcounted "
                        "pages, copy-on-write at the divergence point) — "
                        "only the tail is prefilled, streams identical to "
                        "cold prefill")
    p.add_argument("--tenant-page-quota", type=float, default=0.0,
                   help="a tenant's PRIVATE-page ceiling as a fraction of "
                        "the page pool (0 = none): a request of a tenant "
                        "whose unshared pages would pass it waits at "
                        "admission; shared prefix pages are free. Requires "
                        "--prefix-cache")
    p.add_argument("--weights-dtype", default="float32",
                   choices=("float32", "int8"),
                   help="serving weight precision: int8 quantizes every "
                        "attention/MLP projection at load (per-channel fp32 "
                        "scales, dequantized per call; activations and "
                        "logits unchanged) at ~0.5x resident projection "
                        "bytes of bf16")
    p.add_argument("--kv-dtype", default="float32",
                   choices=("float32", "int8"),
                   help="paged KV precision: int8 pools + fp32 "
                        "per-page-per-head scale pools, quantized on write "
                        "and dequantized in the paged kernels ((head_dim + "
                        "4) bytes a head and token; the page count and "
                        "admission are unchanged)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor parallelism: shard THIS replica's engine "
                        "over N processes, one a card (attention heads + "
                        "MLP hidden on a model-axis mesh, paged KV pools "
                        "split on the head dim; page counts are tp=1's). "
                        "Requires a model whose num_heads/intermediate_size "
                        "divide by N and a launch of N processes "
                        "(torch.distributed.run --nproc-per-node N)")
    p.add_argument("--deadline-s", type=float, default=0.0,
                   help="default per-request deadline (0 = none)")
    return p


def engine_config(args):
    """The ``EngineConfig`` of parsed ``args`` (the leader's and every
    follower's)."""
    from pytorch_distributed_training_tpu_torch.serve import EngineConfig

    return EngineConfig(
        num_slots=args.num_slots,
        prompt_buckets=tuple(
            int(b) for b in args.prompt_buckets.split(",") if b.strip()
        ),
        max_new_tokens=args.max_new_tokens_cap,
        kv_layout=args.kv_layout,
        page_size=args.page_size,
        num_pages=args.num_pages,
        sampling=args.sampling,
        spec_k=args.spec_k,
        spec_draft=draft_lane(args),
        prefill_chunk=args.prefill_chunk,
        prefill_concurrency=args.prefill_concurrency,
        prefix_cache=args.prefix_cache,
        tenant_page_quota=args.tenant_page_quota,
        tp=args.tp,
        weights_dtype=args.weights_dtype,
        kv_dtype=args.kv_dtype,
    )


def draft_lane(args) -> str:
    """The draft lane ``args`` ask for: "model" with ``--spec-k`` and
    ``--draft-checkpoint``, else "ngram"."""
    return "model" if args.spec_k > 0 and args.draft_checkpoint else "ngram"


def _draft(args, tok):
    """The draft lane's model (None for the n-gram lane): ``--draft-model``
    loaded from ``--draft-checkpoint`` through ``load_model_and_params`` on
    a copy of ``args``, so the boot step, trunk layout and vocabulary
    checks are the base model's (JAX ``cli/serve_lm``)."""
    from pytorch_distributed_training_tpu_torch.cli.generate_lm import (
        load_model_and_params,
    )

    if draft_lane(args) != "model":
        return None
    draft_args = argparse.Namespace(**{
        **vars(args), "model": args.draft_model,
        "checkpoint_dir": args.draft_checkpoint, "hf_checkpoint": None})
    return load_model_and_params(draft_args, tok)[0]


def _model(args):
    """``(model, tokenizer, ckpt_step, draft)`` of parsed ``args``: the
    model on the CPU, float32, from ``--checkpoint-dir``,
    ``--hf-checkpoint`` or ``--seed`` (the same on every rank;
    ``cli/generate_lm.py``), and the draft lane's model or None."""
    import torch

    from pytorch_distributed_training_tpu_torch.cli.generate_lm import (
        build_tokenizer,
        load_model_and_params,
    )

    # the float32 logits product must stay float32 (no TF32 rounding)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tok = build_tokenizer(args)
    model, step = load_model_and_params(args, tok)
    return model, tok, step, _draft(args, tok)


def build_server(args, *, device=None, shard=None):
    """``(server, tokenizer)`` for parsed ``args``: the model on its device
    behind an unstarted ``InferenceServer`` (``device``: ``--device``'s
    when None; ``shard``: the model axis under ``--tp``, this rank the
    leader)."""
    from pytorch_distributed_training_tpu_torch.serve import InferenceServer
    from pytorch_distributed_training_tpu_torch.utils.device import (
        resolve_device,
    )

    if device is None:
        device = resolve_device(args.device)  # before any weights are built
    model, tok, step, draft = _model(args)
    # the engine serves its own cast copy of the model (and of the draft)
    server = InferenceServer(
        model, engine_config(args), device=device,
        queue_depth=args.queue_depth,
        default_deadline_s=args.deadline_s or None, shard=shard,
        weights_step=step, draft_model=draft,
    )
    return server, tok


def _serve(server, tok, in_stream, out_stream) -> dict:
    """Serve stdio until EOF; the engine's final stats."""
    from pytorch_distributed_training_tpu_torch.serve import serve_stdio
    from pytorch_distributed_training_tpu_torch.utils.logging import log0

    server.start()
    try:
        served = serve_stdio(
            server, tok,
            in_stream if in_stream is not None else sys.stdin,
            out_stream if out_stream is not None else sys.stdout,
        )
        log0(f"stdio stream closed after {served} requests")
    finally:
        server.close(drain=True)
    return server.stats()


def _main_tp(args, in_stream, out_stream) -> dict:
    """``--tp N``: join the launcher's process group, one model group of N
    ranks; rank 0 serves stdio as the leader, the others follow until its
    stop message. Rank 0 returns the engine's stats, a follower its own."""
    from pytorch_distributed_training_tpu_torch.comms.bootstrap import (
        initialize,
        shutdown,
    )
    from pytorch_distributed_training_tpu_torch.comms.collectives import (
        broadcast_call,
    )
    from pytorch_distributed_training_tpu_torch.comms.mesh import build_mesh
    from pytorch_distributed_training_tpu_torch.serve import run_follower
    from pytorch_distributed_training_tpu_torch.serve.engine import CALL_STOP
    from pytorch_distributed_training_tpu_torch.utils.config import (
        MeshConfig,
    )
    from pytorch_distributed_training_tpu_torch.utils.device import (
        resolve_device,
    )

    info = initialize(resolve_device(args.device))
    try:
        if info.world_size != args.tp:
            raise ValueError(
                f"--tp {args.tp} must equal the world size "
                f"{info.world_size} (launch --nproc-per-node {args.tp})")
        shard = build_mesh(MeshConfig(data=1, model=args.tp),
                           rank=info.rank,
                           world_size=info.world_size).shard("model")
        if shard.index:
            model, _, _, draft = _model(args)
            return run_follower(model, engine_config(args),
                                device=info.device, shard=shard,
                                draft_model=draft)
        try:
            server, tok = build_server(args, device=info.device, shard=shard)
        except BaseException:
            broadcast_call(shard, CALL_STOP)  # the followers wait on a call
            raise
        return _serve(server, tok, in_stream, out_stream)
    finally:
        shutdown()


def main(argv=None, in_stream=None, out_stream=None) -> dict:
    """Serve until EOF on the input stream; returns the engine's final
    stats dict (under ``--tp``, a follower's own stats on ranks above
    0)."""
    args = build_parser().parse_args(argv)
    if args.tp > 1:
        return _main_tp(args, in_stream, out_stream)
    server, tok = build_server(args)
    return _serve(server, tok, in_stream, out_stream)


if __name__ == "__main__":
    main()
