"""Text generation for the causal LM over the dense decode cache, and the
model and tokenizer loading shared with the serving CLI (counterpart: the
JAX package's ``cli/generate_lm.py``)::

    python -m pytorch_distributed_training_tpu_torch.cli.generate_lm \\
        --model gpt2-medium --checkpoint-dir /ckpts/run1 \\
        --prompt "The quick brown" --max-new-tokens 32 --temperature 0.8

``--prompt-file`` reads one prompt a line and generates the whole file as
one ragged right-padded batch (``models/generate.py``), printing every
row's continuation. Weights come from a trainer checkpoint
(``--checkpoint-dir``: the newest verified step, else the latest of a
legacy directory; its trunk layout read from the metadata), an HF GPT-2
checkpoint directory (``--hf-checkpoint``, ``models/hf_loader.py``) or
random init from ``--seed`` (demo mode). Tokenization uses the byte-level
BPE when ``--vocab``/``--merges`` are given, else the raw-byte fallback.
Runs on the GPU (``--device cuda``, the default) or with ``--device cpu``.
``build_tokenizer`` and ``load_model_and_params`` are what
``cli/serve_lm.py`` boots with.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_model_args(p)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where generation runs (cuda raises when no GPU is "
                        "visible)")
    p.add_argument("--prompt", default="The quick brown fox")
    p.add_argument("--prompt-file", default=None,
                   help="one prompt per line; generates the whole file as a "
                        "single ragged batch and prints every row")
    p.add_argument("--max-new-tokens", type=int, default=32)
    p.add_argument("--temperature", type=float, default=0.0,
                   help="0 = greedy; >0 = sampling")
    p.add_argument("--top-k", type=int, default=40)
    p.add_argument("--stop-at-eot", action=argparse.BooleanOptionalAction,
                   default=True)
    return p


def add_model_args(p: argparse.ArgumentParser) -> None:
    """Model/checkpoint/tokenizer flags shared by the LM entry points."""
    p.add_argument("--model", default="gpt2-medium")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint-dir", default=None,
                   help="framework checkpoint directory (trainer format)")
    p.add_argument("--hf-checkpoint", default=None,
                   help="HF GPT-2 checkpoint directory (torch weights)")
    p.add_argument("--vocab", default=None, help="encoder.json path")
    p.add_argument("--merges", default=None, help="merges.txt path")


def build_tokenizer(args):
    from pytorch_distributed_training_tpu_torch.data.bpe import (
        ByteLevelBPETokenizer,
        ByteTokenizer,
    )
    from pytorch_distributed_training_tpu_torch.utils.logging import log0

    if args.vocab and args.merges:
        return ByteLevelBPETokenizer(args.vocab, args.merges)
    log0("no --vocab/--merges: using raw-byte fallback tokenizer")
    return ByteTokenizer()


def boot_step(directory: str) -> int:
    """The step an inference process boots from (JAX ``cli/generate_lm``'s
    rule): the newest integrity-verified step, so it never boots on a torn
    publish; when none verifies, the latest step, loaded unverified with a
    log line (a legacy manifest-less save, or every manifest failing);
    ``SystemExit`` when the directory holds no step. A training restore
    refuses such a directory instead (``train/checkpoint.
    restore_candidates``)."""
    from pytorch_distributed_training_tpu_torch.train import (
        checkpoint as ckpt,
    )
    from pytorch_distributed_training_tpu_torch.utils.logging import log0

    step = ckpt.verified_latest_step(directory)
    if step is None:
        step = ckpt.latest_step(directory)
        if step is None:
            raise SystemExit(f"no checkpoint under {directory}")
        log0(f"no integrity-verified checkpoint under {directory} (legacy "
             f"save?); loading latest step {step} unverified")
    return step


def load_model_and_params(args, tok):
    """``(model, ckpt_step)``: a ``GPT2LMModel`` of ``--model`` on the CPU
    with float32 parameters, and the checkpoint step it was loaded from
    (None for HF or random weights; serving reports it as the boot
    ``weights_step``).

    The step is resolved once (``boot_step``); the model takes the
    checkpoint's trunk layout (``saved_params_scanned``, the metadata
    only), and only its tensors are read (``restore_params``: no
    moments)."""
    from pytorch_distributed_training_tpu_torch.models.gpt2 import GPT2LMModel
    from pytorch_distributed_training_tpu_torch.utils.config import (
        model_preset,
    )
    from pytorch_distributed_training_tpu_torch.utils.logging import log0

    scanned = False
    ckpt_step = None
    ckpt = None
    if args.checkpoint_dir and not args.hf_checkpoint:
        from pytorch_distributed_training_tpu_torch.train import (
            checkpoint as ckpt,
        )

        ckpt_step = boot_step(args.checkpoint_dir)
        scanned = ckpt.saved_params_scanned(args.checkpoint_dir,
                                            step=ckpt_step)
    mcfg = model_preset(args.model, scan_layers=scanned)
    if not mcfg.causal:
        raise SystemExit(f"--model {args.model} is not a causal preset")
    if tok.vocab_size > mcfg.vocab_size:
        raise SystemExit(
            f"tokenizer vocab {tok.vocab_size} exceeds model vocab "
            f"{mcfg.vocab_size}"
        )
    if args.hf_checkpoint:
        from pytorch_distributed_training_tpu_torch.models.hf_loader import (
            load_gpt2_lm,
        )

        state = load_gpt2_lm(args.hf_checkpoint, mcfg)
    elif ckpt is not None:
        names = GPT2LMModel(mcfg, device="meta").state_dict()
        state = ckpt.restore_params(args.checkpoint_dir, like=names,
                                    step=ckpt_step)
    else:
        log0("no checkpoint given: generating from RANDOM weights (demo)")
        gen = torch.Generator().manual_seed(args.seed)
        return GPT2LMModel(mcfg, generator=gen), None
    model = GPT2LMModel(mcfg, device="meta")
    model.load_state_dict(state, assign=True)
    return model, ckpt_step


def _trim_eot(ids: np.ndarray, tok, stop_at_eot: bool) -> np.ndarray:
    if stop_at_eot and getattr(tok, "eot_id", None) is not None:
        stops = np.where(ids == tok.eot_id)[0]
        if len(stops):
            return ids[: stops[0]]
    return ids


def main(argv=None):
    """Generate and print continuations. Returns the continuation text: a
    str for ``--prompt``, a list[str] (one per line) for
    ``--prompt-file``."""
    from pytorch_distributed_training_tpu_torch.models.generate import (
        generate,
    )
    from pytorch_distributed_training_tpu_torch.utils.device import (
        resolve_device,
    )

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)  # before any weights are built
    tok = build_tokenizer(args)
    if args.prompt_file:
        with open(args.prompt_file) as f:
            prompts = [line.rstrip("\n") for line in f if line.strip()]
        if not prompts:
            raise SystemExit(f"no prompts in {args.prompt_file}")
    else:
        prompts = [args.prompt]

    rows = [tok.text_ids(p) for p in prompts]
    if any(len(r) == 0 for r in rows):
        raise SystemExit("empty prompt after tokenization")
    lengths = np.asarray([len(r) for r in rows], np.int64)
    width = int(lengths.max())
    prompt_ids = np.zeros((len(rows), width), np.int64)
    for i, r in enumerate(rows):
        prompt_ids[i, : len(r)] = r

    # the float32 logits product must stay float32 (no TF32 rounding)
    torch.backends.cuda.matmul.allow_tf32 = False
    model, _step = load_model_and_params(args, tok)
    model = model.to(device).eval()
    out = generate(
        model, prompt_ids, max_new_tokens=args.max_new_tokens,
        prompt_lengths=lengths, temperature=args.temperature,
        top_k=args.top_k,
        generator=torch.Generator(device=device).manual_seed(args.seed),
        eot_id=getattr(tok, "eot_id", None) if args.stop_at_eot else None,
    ).cpu().numpy()
    texts = []
    for i, prompt in enumerate(prompts):
        ids = _trim_eot(out[i, width:], tok, args.stop_at_eot)
        text = tok.decode(ids)
        texts.append(text)
        print(prompt + text)
    return texts if args.prompt_file else texts[0]


if __name__ == "__main__":
    main()
