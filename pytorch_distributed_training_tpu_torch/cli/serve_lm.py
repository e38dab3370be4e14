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
deadline. Events go to stdout, logs to stderr.
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
    p.add_argument("--page-size", type=int, default=16,
                   help="tokens per KV page")
    p.add_argument("--num-pages", type=int, default=0,
                   help="total KV pages incl. the reserved null page (0 = "
                        "auto-size so every slot fits a worst-case request)")
    p.add_argument("--deadline-s", type=float, default=0.0,
                   help="default per-request deadline (0 = none)")
    return p


def build_server(args):
    """``(server, tokenizer)`` for parsed ``args``: the model on its device
    behind an unstarted ``InferenceServer``."""
    import torch

    from pytorch_distributed_training_tpu_torch.cli.generate_lm import (
        build_tokenizer,
        load_model_and_params,
    )
    from pytorch_distributed_training_tpu_torch.serve import (
        EngineConfig,
        InferenceServer,
    )
    from pytorch_distributed_training_tpu_torch.utils.device import (
        resolve_device,
    )

    device = resolve_device(args.device)   # before any weights are built
    # the float32 logits product must stay float32 (no TF32 rounding)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    tok = build_tokenizer(args)
    model, _step = load_model_and_params(args, tok)
    config = EngineConfig(
        num_slots=args.num_slots,
        prompt_buckets=tuple(
            int(b) for b in args.prompt_buckets.split(",") if b.strip()
        ),
        max_new_tokens=args.max_new_tokens_cap,
        page_size=args.page_size,
        num_pages=args.num_pages,
    )
    # the engine serves its own cast copy of the model
    server = InferenceServer(
        model, config, device=device, queue_depth=args.queue_depth,
        default_deadline_s=args.deadline_s or None,
    )
    return server, tok


def main(argv=None, in_stream=None, out_stream=None) -> dict:
    """Serve until EOF on the input stream; returns the engine's final
    stats dict."""
    from pytorch_distributed_training_tpu_torch.serve import serve_stdio
    from pytorch_distributed_training_tpu_torch.utils.logging import log0

    server, tok = build_server(build_parser().parse_args(argv))
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


if __name__ == "__main__":
    main()
