#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (one NVIDIA GPU).

    python3 chip_smoke.py

Drives ``pytorch_distributed_training_tpu_torch`` only (never JAX, nothing of
the JAX package), in phases that each raise on failure:

1. device: a CUDA GPU must be visible; prints ``nvidia-smi``'s name and
   power limit;
2. build: compiles every CUDA source of the port from
   ``pytorch_distributed_training_tpu_torch/csrc`` with ``nvcc`` for
   ``sm_90a``, one process per source, all at once;
3. kernels: holds each kernel against its plain PyTorch version on the
   card (tolerances below; the dropout masks bit for bit), backward kernels
   through ``torch.autograd.grad``, and times kernel, plain version and the
   library yardstick at the main paths' shapes with CUDA-graph replay (the
   flash kernels against ``F.scaled_dot_product_attention``);
4. train: runs the port's ``train_dp`` on bert-large-cased at full width
   and depth (3 optimizer steps of 96 = 8 x 12 on the synthetic MRPC task,
   then the full 408-row eval), with the launch counters reset just before
   and read just after and checked against the counts the step derives;
   finite losses, moved parameters, bit-identical per-step losses in a
   second run; a third run under ``torch.profiler``;
5. cpu-vs-card: the ``tiny`` preset with dropout on, trained 2 steps on
   the CPU (plain versions) and on the card (kernels) from one seed: the
   per-step losses agree, so the card's masks are the plain generator's;
   then the same for ``gpt2-tiny`` through ``train_lm`` (the
   whole-sequence flash kernels);
6. lm: runs the port's ``train_lm`` on gpt2-medium at full width and
   depth, at seq 1024 (3 optimizer steps of 32 = 4 x 8, then a 64-row
   eval: the blockwise flash kernels) and at seq 128 (1 step of 96 = 8 x
   12, then a 32-row eval: the whole-sequence pair), the launch counters
   reset just before each and read just after and checked against the
   counts the step derives; finite losses, moved parameters, bit-identical
   per-step losses in a second seq-1024 run, and a third under
   ``torch.profiler``;
7. serve: runs the port's ``serve_lm`` main on gpt2-medium at full width
   (random weights from ``--seed 0``) over a JSONL request stream, with the
   kernels' launch counters reset just before and read just after; checks
   every request's token count, the launch counts against the engine's
   prefill and decode counts, greedy streams identical across two runs, and
   each served token against a full-sequence forward of the same model;
   a further run under ``torch.profiler`` breaks the device time down by
   kernel class.

Prints one ``kernels`` JSON line and, last, ``{"ok": true, "device": ...}``.
Exits non-zero, with no result, when no CUDA GPU is visible or any phase
fails.
"""

from __future__ import annotations

import functools
import gc
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet (dense): HBM3 rate, and the float32 rate
# outside the tensor cores, where these kernels do their arithmetic
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

LN_HIDDEN = 1024
LN_ROWS = (4, 16, 128, 4096)
# LayerNorm tolerance per element: 1 bf16 ulp of the element, plus the
# float32 difference of two summation orders and rsqrt roundings before the
# cast (a few float32 ulps of unit-scale terms), which alone can move an
# output near zero by many of its own tiny ulps
LN_FP32_SLACK = 2.0 ** -16
PAGED = dict(batch=8, heads=16, head_dim=64, page_size=16)
PAGED_LENGTHS = (1, 15, 16, 17, 300, 1024, 64, 513)
PAGED_TOL = 2e-2          # atol = rtol, bf16 output vs float32 plain version
# decode tick of the serve phase: 8 slots, block-table rows of
# (128 + 64) / 16 pages, contexts of prompts up to 120 bytes + 32 tokens
SERVE_CONTEXTS = (17, 33, 48, 65, 90, 120, 140, 152)
SERVE_WINDOWS = 12

SERVE_ARGS = ["--model", "gpt2-medium", "--device", "cuda", "--seed", "0",
              "--num-slots", "8", "--prompt-buckets", "16,32,64,128",
              "--max-new-tokens-cap", "64"]
NEW_TOKENS = 32
PROMPTS = tuple(
    ("The quick brown fox jumps over the lazy dog. " * 3)[:n]
    for n in (5, 12, 16, 23, 31, 40, 57, 64, 77, 96, 110, 120)
)
# full-sequence check: a served greedy token's logit may trail the
# full-sequence maximum by this much (bf16 activations over 24 layers,
# other matmul shapes; logits of the random model have a spread of ~0.6)
MARGIN_TOL = 0.1

# training-kernel shapes: the main path's rows 8 x 128 = 1024 at H 1024,
# ragged row counts, and the widths of the tiny and bert-base presets
TRAIN_SHAPES = ((1024, 1024), (8, 1024), (1000, 1024), (4096, 1024),
                (1024, 64), (1024, 768), (1000, 768), (8, 64))
MAIN_ROWS, MAIN_H = 1024, 1024
DROPOUT_RATE = 0.1        # hidden_dropout = attention_dropout of the presets
# the probs of bert-large at micro 8, seq 128; its embeddings; ragged sizes
MASK_SHAPES = ((8, 16, 128, 128), (8, 128, 1024), (1000, 3), (7,), (8, 1024))
# float32 dscale/dbias sums over rows in another order: |got - want| <=
# 2^-16 of the column's sum of absolute terms
PARAM_SUM_SLACK = 2.0 ** -16

TRAIN_ARGS = ["--model", "bert-large-cased", "--task", "synthetic",
              "--train-size", "288", "--eval-size", "408", "--num-epochs",
              "1", "--device", "cuda", "--seed", "42", "--log-every", "0"]
# cpu-vs-card: float32 so the two devices' matmuls agree to ~1e-6 and a
# single differing mask element (a loss change of ~1e-3) shows
TINY_ARGS = ["--model", "tiny", "--task", "synthetic", "--train-size", "32",
             "--eval-size", "32", "--global-batch-size", "16",
             "--micro-batch-size", "8", "--num-epochs", "1", "--seed", "7",
             "--no-bf16", "--warmup-steps", "1", "--learning-rate", "1e-3",
             "--log-every", "0"]
CPU_CARD_RTOL = 1e-4

# flash attention at the LM paths' shapes: gpt2-medium at seq 1024, micro
# 4 (blockwise pair) and at seq 128, micro 8 (whole-sequence pair)
FLASH_BLOCKWISE = (4, 16, 1024, 64)
FLASH_WHOLE = (8, 16, 128, 64)
# bf16 outputs against the plain version's: 2 bf16 ulps of the element
# plus 1e-3 of the tensor's largest magnitude (float32 sums in another
# order; p rounded to bf16 against another running max)
FLASH_BF16_ULPS = 2
FLASH_BF16_SLACK = 1e-3
# float32 case, rate 0.1, q = 0 (each visible key weighs 1 / its row's
# count, >= 1/1024) and v, dO in [1, 1.5): a single differing mask element
# moves its row of o, and its key's row of dv, by >= 1 / (0.9 * 1024) ~
# 1.1e-3 in every column; the kernels' float32 error is ~1e-6
FLASH_FP32_TOL = 1e-5
# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate (the flash
# inputs' type)
BF16_FLOPS_PER_S = 989e12

LM_1024_ARGS = ["--model", "gpt2-medium", "--task", "lm",
                "--max-seq-length", "1024", "--global-batch-size", "32",
                "--micro-batch-size", "4", "--train-size", "96",
                "--eval-size", "64", "--num-epochs", "1", "--seed", "42",
                "--log-every", "0", "--device", "cuda"]
LM_128_ARGS = ["--model", "gpt2-medium", "--task", "lm", "--train-size", "96",
               "--eval-size", "32", "--num-epochs", "1", "--seed", "42",
               "--log-every", "0", "--device", "cuda"]
# gpt2-tiny keeps "reference" attention as its preset; --attention flash
# puts the whole-sequence kernels (head_dim 16, float32) on the path
TINY_LM_ARGS = ["--model", "gpt2-tiny", "--attention", "flash", "--task", "lm",
                "--train-size", "32",
                "--eval-size", "32", "--global-batch-size", "16",
                "--micro-batch-size", "8", "--num-epochs", "1", "--seed", "7",
                "--no-bf16", "--warmup-steps", "1", "--learning-rate", "1e-3",
                "--log-every", "0"]

_PKG = "pytorch_distributed_training_tpu"
REPLACES = {
    "layer_norm": f"{_PKG}/ops/layer_norm.py:102",
    "layer_norm_bwd": f"{_PKG}/ops/layer_norm.py:131",
    "dropout_add_layer_norm": f"{_PKG}/ops/layer_norm.py:296",
    "dropout_add_layer_norm_bwd": f"{_PKG}/ops/layer_norm.py:345",
    "mask_scale": f"{_PKG}/ops/dropout.py:107",
    "paged_attention": f"{_PKG}/ops/paged_attention.py:238",
    "flash_fwd": f"{_PKG}/ops/flash_attention.py:103",
    "flash_bwd": f"{_PKG}/ops/flash_attention.py:360",
    "flash_whole_fwd": f"{_PKG}/ops/flash_attention.py:467",
    "flash_whole_bwd": f"{_PKG}/ops/flash_attention.py:505",
}


def say(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, *, reps: int = 25, inner: int = 20) -> float:
    """Device time of one call, in ms: ``inner`` calls captured in a CUDA
    graph, the graph replayed ``reps`` times between CUDA events, the
    median per call. The graph takes the host's launch cost out, so a
    small kernel is timed on the card and not at the host's launch rate."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def eager_ms(fn, *, reps: int = 25, inner: int = 10) -> float:
    """Time of one eager call back to back, in ms (CUDA events around
    ``inner`` calls, median of ``reps``): the rate a caller launching it
    from Python gets, which for a small kernel is the host's."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bound(n_bytes: float, flops: float,
          flops_per_s: float = FP32_FLOPS_PER_S) -> tuple[float, str]:
    """Least time for the work on the card, in ms, and what bounds it."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / flops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def bf16_ulp(x):
    import torch

    a = x.abs().float().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def check_ln_close(what, got, want) -> float:
    """Per element: 1 bf16 ulp of the larger magnitude + LN_FP32_SLACK.
    Returns the largest error; raises beyond the tolerance."""
    import torch

    g, w = got.float(), want.float()
    err = (g - w).abs()
    tol = bf16_ulp(torch.maximum(g.abs(), w.abs())) + LN_FP32_SLACK
    bad = err > tol
    if bad.any() or not torch.isfinite(g).all():
        raise AssertionError(
            f"{what}: {int(bad.sum())} elements beyond 1 bf16 ulp + "
            f"{LN_FP32_SLACK}: got {g[bad][:4].tolist()} want "
            f"{w[bad][:4].tolist()}"
        )
    return float(err.max())


def check_sums(what, got, want, abs_terms) -> float:
    """float32 column sums (dscale, dbias) taken in another order: within
    PARAM_SUM_SLACK of each column's sum of absolute terms."""
    err = (got.float() - want.float()).abs()
    bad = err > PARAM_SUM_SLACK * abs_terms
    if bad.any():
        raise AssertionError(
            f"{what}: {int(bad.sum())} columns beyond {PARAM_SUM_SLACK} x "
            f"sum |terms|: err {err[bad][:4].tolist()}"
        )
    return float((err / abs_terms.clamp_min(1e-30)).max())


def check_launches(what, counts, want) -> None:
    """Every kernel launched exactly ``want`` times (0 when not named) and
    every named kernel at least once."""
    from pytorch_distributed_training_tpu_torch.ops import _build

    for name in _build.KERNELS:
        got, need = counts.get(name, 0), want.get(name, 0)
        if got != need or (name in want and need == 0):
            raise AssertionError(
                f"{name}: {got} launches in the {what}, want {need}"
            )


# ------------------------------------------------------------- phase 1, 2


def device_phase() -> str:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    say(f"[device] {smi}")
    say(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    return smi


def build_phase() -> None:
    from pytorch_distributed_training_tpu_torch.ops import _build

    t0 = time.perf_counter()
    per = _build.build()
    say(f"[build] {len(per)} kernels built in "
        f"{time.perf_counter() - t0:.1f} s "
        + json.dumps({k: round(v, 1) for k, v in per.items()}))
    for name, log in _build.BUILD_LOGS.items():
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
        spills = [int(m) for m in re.findall(r"(\d+) bytes spill", log)]
        say(f"[build] {name}: {len(regs)} instantiations, registers "
            f"{min(regs, default=0)}..{max(regs, default=0)}, spill bytes "
            f"{sum(spills)}")


# ---------------------------------------------------------------- phase 3


def layer_norm_phase(device, rows=LN_ROWS, hidden=LN_HIDDEN,
                     serve_rows=8) -> dict:
    import torch
    import torch.nn.functional as F

    from pytorch_distributed_training_tpu_torch.ops.layer_norm import (
        layer_norm,
        reference_layer_norm,
    )

    g = torch.Generator(device=device).manual_seed(0)
    scale = 1.0 + 0.1 * torch.randn(hidden, generator=g, device=device)
    bias = 0.1 * torch.randn(hidden, generator=g, device=device)
    worst = 0.0
    for n in rows:
        for in_dtype in (torch.bfloat16, torch.float32):
            x = (3.0 + 2.0 * torch.randn(n, hidden, generator=g,
                                         device=device)).to(in_dtype)
            got = layer_norm(x, scale, bias, eps=1e-5,
                             out_dtype=torch.bfloat16)
            want = reference_layer_norm(x, scale, bias, eps=1e-5,
                                        out_dtype=torch.bfloat16)
            worst = max(worst, check_ln_close(
                f"layer_norm rows={n} {in_dtype}", got, want))
    say(f"[kernels] layer_norm parity ok: rows {list(rows)} x "
        f"{{bf16, f32}} in -> bf16 out, max abs err {worst} (<= 1 bf16 "
        f"ulp + {LN_FP32_SLACK} per element)")

    timings = {}
    for n in (serve_rows, 128, MAIN_ROWS, 4096):
        x = torch.randn(n, hidden, generator=g, device=device,
                        dtype=torch.bfloat16)
        sb, bb = scale.bfloat16(), bias.bfloat16()
        kernel = functools.partial(layer_norm, x, scale, bias, eps=1e-5,
                                   out_dtype=torch.bfloat16)
        t = dict(
            ms=time_ms(kernel), eager_ms=eager_ms(kernel),
            plain_ms=time_ms(lambda: reference_layer_norm(
                x, scale, bias, eps=1e-5, out_dtype=torch.bfloat16)),
            library_ms=time_ms(lambda: F.layer_norm(x, (hidden,), sb, bb,
                                                    1e-5)),
        )
        t["bound_ms"], t["bound_by"] = bound(
            n * hidden * 2 * 2 + 2 * hidden * 4, 8.0 * n * hidden
        )
        timings[n] = t
        say(f"[kernels] layer_norm rows={n} H={hidden} bf16->bf16: "
            + json.dumps(t))
    return dict(max_abs_err=worst, **timings[MAIN_ROWS],
                serve=timings[serve_rows])


def paged_inputs(device, lengths, *, windows, batch, heads, head_dim,
                 page_size, seed=0):
    """bf16 pools filled with noise (the null page 0 included), each
    sequence's pages in a random order, block-table tails on page 0."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    need = [-(-n // page_size) for n in lengths]
    num_pages = 1 + sum(need) + 3
    shape = (num_pages, page_size, heads, head_dim)
    k_pages = torch.randn(shape, generator=g, device=device).bfloat16()
    v_pages = torch.randn(shape, generator=g, device=device).bfloat16()
    order = (torch.randperm(num_pages - 1, generator=g, device=device)
             + 1).tolist()
    bt = torch.zeros(batch, windows, dtype=torch.int32)
    for b, n in enumerate(need):
        bt[b, :n] = torch.tensor([order.pop() for _ in range(n)])
    q = torch.randn(batch, heads, head_dim, generator=g,
                    device=device).bfloat16()
    lens = torch.tensor(lengths, dtype=torch.int32)
    return q, k_pages, v_pages, bt.to(device), lens.to(device)


def paged_bound(lengths, *, batch, heads, head_dim, page_size):
    tokens = sum(lengths)
    n_bytes = (tokens * heads * head_dim * 2 * 2          # K and V, bf16
               + 2 * batch * heads * head_dim * 2          # q in, out
               + sum(-(-n // page_size) for n in lengths) * 4 + batch * 4)
    return bound(n_bytes, 4.0 * tokens * heads * head_dim)


def paged_phase(device, lengths=PAGED_LENGTHS, serve=SERVE_CONTEXTS,
                serve_windows=SERVE_WINDOWS, geometry=None) -> dict:
    import torch
    import torch.nn.functional as F

    from pytorch_distributed_training_tpu_torch.ops.paged_attention import (
        _paged_reference,
        paged_attention,
    )

    geo = dict(PAGED, **(geometry or {}))
    scale = geo["head_dim"] ** -0.5
    windows = -(-max(lengths) // geo["page_size"])
    q, kp, vp, bt, lens = paged_inputs(device, lengths, windows=windows,
                                       **geo)
    got = paged_attention(q, kp, vp, bt, lens, scale=scale)
    want = _paged_reference(q.float(), kp.float(), vp.float(), bt, lens,
                            scale)
    if got.dtype != torch.bfloat16 or got.shape != want.shape:
        raise AssertionError(f"paged_attention gave {got.dtype} "
                             f"{tuple(got.shape)}")
    torch.testing.assert_close(got.float(), want, atol=PAGED_TOL,
                               rtol=PAGED_TOL)
    err = float((got.float() - want).abs().max())
    say(f"[kernels] paged_attention parity ok: lengths {list(lengths)}, "
        f"permuted pages, null-page tails, max abs err {err} "
        f"(atol=rtol={PAGED_TOL})")

    timings = {}
    for label, lens_list, w in (("serve", serve, serve_windows),
                                ("parity", lengths, windows)):
        q, kp, vp, bt, lens = paged_inputs(device, lens_list, windows=w,
                                           seed=1, **geo)
        # the library yardstick: SDPA over K/V gathered beforehand
        idx = bt.long()
        b, h, d = q.shape
        kg = kp[idx].reshape(b, -1, h, d).transpose(1, 2).contiguous()
        vg = vp[idx].reshape(b, -1, h, d).transpose(1, 2).contiguous()
        mask = (torch.arange(kg.shape[2], device=device)[None]
                < lens[:, None])[:, None, None, :]
        q4 = q[:, :, None]
        kernel = functools.partial(paged_attention, q, kp, vp, bt, lens,
                                   scale=scale)
        t = dict(
            ms=time_ms(kernel), eager_ms=eager_ms(kernel),
            plain_ms=time_ms(lambda: _paged_reference(q, kp, vp, bt, lens,
                                                      scale)),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q4, kg, vg, attn_mask=mask, scale=scale)),
        )
        t["bound_ms"], t["bound_by"] = paged_bound(lens_list, **geo)
        timings[label] = t
        say(f"[kernels] paged_attention {label} lengths {list(lens_list)} "
            f"W={w}: " + json.dumps(t))
    return dict(max_abs_err=err, **timings["serve"])


# ---------------------------------------------------------------- phase 6


def request_lines(prompts, new_tokens) -> str:
    return "".join(
        json.dumps({"id": f"r{i}", "prompt": p,
                    "max_new_tokens": new_tokens}) + "\n"
        for i, p in enumerate(prompts)
    )


def serve_once(argv, prompts, new_tokens):
    """One run of the port's serve_lm over a JSONL stream; returns (events,
    stats, launch counts of this run, wall seconds)."""
    from pytorch_distributed_training_tpu_torch.cli import serve_lm
    from pytorch_distributed_training_tpu_torch.ops import _build

    text = request_lines(prompts, new_tokens)
    out = io.StringIO()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    stats = serve_lm.main(argv, in_stream=io.StringIO(text), out_stream=out)
    wall = time.perf_counter() - t0
    counts = dict(_build.LAUNCH_COUNTS)
    events = [json.loads(line) for line in out.getvalue().splitlines()]
    return events, stats, counts, wall


def streams(events, prompts, new_tokens) -> dict:
    """Per-request token ids; raises unless every request ended ``done``
    with ``new_tokens`` tokens."""
    toks = {f"r{i}": [] for i in range(len(prompts))}
    done = {}
    for e in events:
        if e["event"] == "token":
            toks[e["id"]].append(e["token_id"])
        elif e["event"] == "done":
            done[e["id"]] = e
        else:
            raise AssertionError(f"serve emitted {e}")
    for rid, ids in toks.items():
        d = done.get(rid)
        if (d is None or d["status"] != "done"
                or d["new_tokens"] != new_tokens or len(ids) != new_tokens):
            raise AssertionError(f"{rid}: {len(ids)} tokens, done={d}")
    return toks


def serve_metrics(events, stats, wall) -> dict:
    ttft = [e["ttft_s"] for e in events if e["event"] == "done"]
    return dict(
        wall_s=wall, prefills=stats["admitted"],
        decode_ticks=stats["decode_dispatches"],
        decode_tokens=stats["decode_tokens"], decode_s=stats["decode_s"],
        decode_tok_per_s=stats["decode_tokens"] / stats["decode_s"],
        decode_tick_ms=1e3 * stats["decode_s"] / stats["decode_dispatches"],
        prefill_s=stats["prefill_s"],
        prefill_ms_mean=1e3 * stats["prefill_s"] / stats["admitted"],
        ttft_p50_s=statistics.median(ttft), ttft_max_s=max(ttft),
    )


def serve_phase(argv=SERVE_ARGS, prompts=PROMPTS, new_tokens=NEW_TOKENS,
                n_layers=24) -> dict:
    """The main path, counted (first run, cold), then a warm run that must
    give the same greedy streams."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    events, stats, counts, wall = serve_once(argv, prompts, new_tokens)
    toks = streams(events, prompts, new_tokens)
    peak = torch.cuda.max_memory_allocated()
    prefills, ticks = stats["admitted"], stats["decode_dispatches"]
    check_launches(
        f"serve run ({prefills} prefills, {ticks} ticks)", counts,
        {"layer_norm": (2 * n_layers + 1) * (prefills + ticks),
         "paged_attention": n_layers * ticks},
    )
    cold = dict(requests=len(prompts), new_tokens=new_tokens,
                **serve_metrics(events, stats, wall), peak_mem_bytes=peak,
                launches=counts)
    say("[serve] cold run: " + json.dumps(cold))

    events, stats, _, wall = serve_once(argv, prompts, new_tokens)
    if streams(events, prompts, new_tokens) != toks:
        raise AssertionError("greedy streams differ between two serve runs")
    warm = serve_metrics(events, stats, wall)
    say("[serve] warm run: " + json.dumps(warm))
    say("[serve] greedy streams identical across two runs")
    return dict(cold, warm=warm, streams=toks)


_PORT_KERNELS = (
    ("layer_norm_fwd_kernel", "layer_norm"),
    ("layer_norm_bwd_kernel", "layer_norm_bwd"),
    ("dal_fwd_kernel", "dropout_add_layer_norm"),
    ("dal_bwd_kernel", "dropout_add_layer_norm_bwd"),
    ("mask_scale_kernel", "mask_scale"),
    ("paged_decode_kernel", "paged_attention"),
    ("flash_fwd_kernel<", "flash_fwd / flash_whole_fwd"),
    ("flash_bwd_kernel<", "flash_bwd / flash_whole_bwd"),
    ("flash_dq_sum_kernel", "flash_bwd / flash_whole_bwd dq sum"),
)


def _kernel_class(name: str) -> str:
    for symbol, kernel in _PORT_KERNELS:
        if symbol in name:
            return f"{kernel} (port kernel)"
    low = name.lower()
    if any(k in low for k in ("gemm", "gemv", "xmma", "cutlass", "nvjet")):
        return "matmul"
    if "softmax" in low:
        return "softmax"
    if any(k in low for k in ("index", "gather", "scatter")):
        return "index/gather/scatter"
    if any(k in low for k in ("elementwise", "vectorized", "unroll")):
        return "elementwise"
    if "reduce" in low:
        return "reduction"
    if "memcpy" in low or "memset" in low:
        return "copy"
    return "other"


def profile_phase(warm, argv=SERVE_ARGS, prompts=PROMPTS,
                  new_tokens=NEW_TOKENS) -> dict:
    """Device kernel time of one more serve run under ``torch.profiler``,
    by kernel class, and the device's busy share of the warm run's engine
    seconds (prefill + decode dispatches, each ending in a host copy). The
    server is built first (weights copied to the card) and the profiler
    covers only the requests."""
    from torch.profiler import ProfilerActivity, profile

    from pytorch_distributed_training_tpu_torch.cli import serve_lm
    from pytorch_distributed_training_tpu_torch.serve import serve_stdio

    server, tok = serve_lm.build_server(
        serve_lm.build_parser().parse_args(argv)
    )
    out = io.StringIO()
    server.start()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            serve_stdio(server, tok, io.StringIO(request_lines(
                prompts, new_tokens)), out)
    finally:
        server.close(drain=True)
    events = [json.loads(line) for line in out.getvalue().splitlines()]
    streams(events, prompts, new_tokens)
    engine_s = warm["prefill_s"] + warm["decode_s"]
    res = device_time_by_class(prof, engine_s)
    say("[profile] " + json.dumps(res))
    return res


def device_time_by_class(prof, wall_s, top_n=10) -> dict:
    """Device kernel time of a ``torch.profiler`` run by kernel class, and
    its share of ``wall_s`` (the host seconds of the profiled work)."""
    from torch.autograd import DeviceType

    by_class: dict[str, float] = {}
    top = []
    for e in prof.key_averages():
        # a user range on the device (the optimizer's "Optimizer.step#..."
        # annotation) spans kernels counted on their own: skip it
        if (e.device_type != DeviceType.CUDA or "#" in e.key
                or getattr(e, "is_user_annotation", False)):
            continue
        us = float(getattr(e, "self_device_time_total", 0.0))
        cls = _kernel_class(e.key)
        by_class[cls] = by_class.get(cls, 0.0) + us
        top.append((us, e.count, e.key[:90]))
    total_us = sum(by_class.values())
    for us, count, name in sorted(top, reverse=True)[:top_n]:
        say(f"[profile] {us / 1e3:9.3f} ms {count:6d}x {name}")
    return dict(
        device_kernel_ms=total_us / 1e3,
        busy_share=total_us / 1e6 / wall_s if wall_s else None,
        by_class_ms={k: v / 1e3 for k, v in sorted(
            by_class.items(), key=lambda kv: -kv[1])},
    )


def full_sequence_phase(device, toks, prompts, model_name="gpt2-medium",
                        seed=0) -> dict:
    """Each served greedy token against a full-sequence forward (plain
    attention, no pages) of the same model on the served context."""
    import torch

    from pytorch_distributed_training_tpu_torch.data.bpe import ByteTokenizer
    from pytorch_distributed_training_tpu_torch.models.gpt2 import (
        GPT2LMModel,
    )
    from pytorch_distributed_training_tpu_torch.utils.config import (
        model_preset,
    )

    model = GPT2LMModel(
        model_preset(model_name, attention_impl="reference"),
        generator=torch.Generator().manual_seed(seed),
    ).to(device)
    model.cast_for_serving()
    model.eval()
    tok = ByteTokenizer()
    agree = total = 0
    worst = 0.0
    with torch.inference_mode():
        for i, p in enumerate(prompts):
            served = toks[f"r{i}"]
            ids = tok.text_ids(p) + served[:-1]
            logits = model(torch.tensor([ids], device=device))[0]
            if not torch.isfinite(logits).all():
                raise AssertionError(f"r{i}: non-finite logits")
            rows = logits[len(ids) - len(served):]
            picked = rows.gather(1, torch.tensor(served, device=device)[:, None])
            margin = (rows.max(dim=1).values - picked[:, 0]).float()
            worst = max(worst, float(margin.max()))
            agree += int((margin == 0).sum())
            total += len(served)
    del model
    if worst > MARGIN_TOL:
        raise AssertionError(
            f"a served token trails the full-sequence maximum by {worst} "
            f"(> {MARGIN_TOL})"
        )
    res = dict(tokens=total, argmax_agree=agree, worst_margin=worst)
    say("[check] served vs full-sequence forward: " + json.dumps(res))
    return res


# ------------------------------------------------- phase 3, training kernels


def _ln_train_inputs(g, rows, hidden, device):
    """bf16 activations (mean 3, std 2, as the serving check) and their
    gradient, float32 scale/bias."""
    import torch

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=device)

    x = (3.0 + 2.0 * randn(rows, hidden)).bfloat16()
    dy = randn(rows, hidden).bfloat16()
    scale = 1.0 + 0.1 * randn(hidden)
    bias = 0.1 * randn(hidden)
    return x, dy, scale, bias


def _xhat(x, eps):
    xf = x.float()
    c = xf - xf.mean(dim=-1, keepdim=True)
    return c * (c.square().mean(dim=-1, keepdim=True) + eps).rsqrt()


def _grads(fn, leaves, dy):
    import torch

    leaves = [t.detach().clone().requires_grad_() for t in leaves]
    out = fn(*leaves)
    return out.detach(), torch.autograd.grad(out, leaves, dy)


def ln_bwd_phase(device, shapes=TRAIN_SHAPES, eps=1e-12) -> dict:
    """Kernel 2 through ``torch.autograd.grad`` of the port's LayerNorm
    against autograd through the plain forward."""
    import functools

    import torch

    from pytorch_distributed_training_tpu_torch.ops.layer_norm import (
        _layer_norm_bwd_cuda,
        layer_norm,
        reference_layer_norm,
        reference_layer_norm_bwd,
    )

    g = torch.Generator(device=device).manual_seed(2)
    worst = worst_sum = 0.0
    for rows, hidden in shapes:
        x, dy, scale, bias = _ln_train_inputs(g, rows, hidden, device)
        kw = dict(eps=eps, out_dtype=torch.bfloat16)
        _, got = _grads(functools.partial(layer_norm, **kw),
                        (x, scale, bias), dy)
        _, want = _grads(functools.partial(reference_layer_norm, **kw),
                         (x, scale, bias), dy)
        what = f"layer_norm_bwd rows={rows} H={hidden}"
        worst = max(worst, check_ln_close(what + " dx", got[0], want[0]))
        dyf, xh = dy.float(), _xhat(x, eps)
        worst_sum = max(
            worst_sum,
            check_sums(what + " dscale", got[1], want[1],
                       (dyf * xh).abs().sum(0)),
            check_sums(what + " dbias", got[2], want[2], dyf.abs().sum(0)),
        )
    say(f"[kernels] layer_norm_bwd parity ok: {list(shapes)} bf16, dx max "
        f"abs err {worst} (<= 1 bf16 ulp + {LN_FP32_SLACK}), dscale/dbias "
        f"max err {worst_sum} of the column's sum |terms| (<= "
        f"{PARAM_SUM_SLACK})")
    x, dy, scale, bias = _ln_train_inputs(g, MAIN_ROWS, MAIN_H, device)
    sb, bb = scale.bfloat16(), bias.bfloat16()
    _, mean, rstd = torch.ops.aten.native_layer_norm(x, [MAIN_H], sb, bb,
                                                     eps)
    t = dict(
        ms=time_ms(lambda: _layer_norm_bwd_cuda(x, dy, scale, eps=eps)),
        plain_ms=time_ms(lambda: reference_layer_norm_bwd(x, dy, scale,
                                                          eps=eps)),
        library_ms=time_ms(lambda: torch.ops.aten.native_layer_norm_backward(
            dy, x, [MAIN_H], mean, rstd, sb, bb, [True, True, True])),
    )
    t["bound_ms"], t["bound_by"] = bound(
        MAIN_ROWS * MAIN_H * 2 * 3 + 3 * MAIN_H * 4, 12.0 * MAIN_ROWS * MAIN_H)
    say(f"[kernels] layer_norm_bwd rows={MAIN_ROWS} H={MAIN_H} bf16: "
        + json.dumps(t))
    return dict(max_abs_err=worst, **t)


def dal_phase(device, shapes=TRAIN_SHAPES, rate=DROPOUT_RATE, eps=1e-12):
    """Kernels 3 and 4: the forward's mask against the plain generator bit
    for bit (h = 1, x = 0 makes s the mask-scale itself), s bit for bit at
    random inputs, y and the gradients through ``torch.autograd.grad``
    against the plain forward and backward under autograd (both save s in
    bf16), dh exactly 0 where h was dropped."""
    import functools

    import torch

    from pytorch_distributed_training_tpu_torch.ops.dropout import keep_mask
    from pytorch_distributed_training_tpu_torch.ops.layer_norm import (
        _dal_bwd_cuda,
        _dal_fwd_cuda,
        dropout_add_layer_norm,
        reference_dal_bwd,
        reference_dal_fwd,
        reference_dropout_add_layer_norm,
    )

    g = torch.Generator(device=device).manual_seed(3)
    bf16 = torch.bfloat16
    worst = worst_sum = 0.0
    for rows, hidden in shapes:
        seed, site = 1000 + rows + hidden, 1
        kw = dict(rate=rate, seed=seed, site=site, eps=eps)
        x, dy, scale, bias = _ln_train_inputs(g, rows, hidden, device)
        h = torch.randn(rows, hidden, generator=g, device=device).bfloat16()
        keep = keep_mask((rows, hidden), rate, seed, site, device)
        ones = torch.ones(rows, hidden, dtype=bf16, device=device)
        _, s_mask = _dal_fwd_cuda(ones, torch.zeros_like(ones), scale, bias,
                                  out_dtype=bf16, save_s=True, **kw)
        what = f"dropout_add_layer_norm rows={rows} H={hidden}"
        if not torch.equal(s_mask > 0, keep):
            raise AssertionError(f"{what}: the kernel's mask differs from "
                                 f"the plain generator's")
        _, s_k = _dal_fwd_cuda(h, x, scale, bias, out_dtype=bf16,
                               save_s=True, **kw)
        _, s_p = reference_dal_fwd(h, x, scale, bias, out_dtype=bf16, **kw)
        if not torch.equal(s_k, s_p):
            raise AssertionError(f"{what}: saved s differs from the plain "
                                 f"version's")
        y_k, got = _grads(functools.partial(dropout_add_layer_norm,
                                            out_dtype=bf16, **kw),
                          (h, x, scale, bias), dy)
        y_p, want = _grads(functools.partial(reference_dropout_add_layer_norm,
                                             out_dtype=bf16, **kw),
                           (h, x, scale, bias), dy)
        worst = max(worst, check_ln_close(what + " y", y_k, y_p),
                    check_ln_close(what + "_bwd dh", got[0], want[0]),
                    check_ln_close(what + "_bwd dx", got[1], want[1]))
        if not torch.equal(got[0][~keep], torch.zeros_like(got[0][~keep])):
            raise AssertionError(f"{what}_bwd: dh is not 0 where h dropped")
        dyf, xh = dy.float(), _xhat(s_p, eps)
        worst_sum = max(
            worst_sum,
            check_sums(what + "_bwd dscale", got[2], want[2],
                       (dyf * xh).abs().sum(0)),
            check_sums(what + "_bwd dbias", got[3], want[3],
                       dyf.abs().sum(0)),
        )
    say(f"[kernels] dropout_add_layer_norm fwd/bwd parity ok: "
        f"{list(shapes)} bf16, rate {rate}: masks and s identical to the "
        f"plain version, y/dh/dx max abs err {worst} (<= 1 bf16 ulp + "
        f"{LN_FP32_SLACK}), dscale/dbias max err {worst_sum} of sum |terms|")
    x, dy, scale, bias = _ln_train_inputs(g, MAIN_ROWS, MAIN_H, device)
    h = torch.randn(MAIN_ROWS, MAIN_H, generator=g, device=device).bfloat16()
    kw = dict(rate=rate, seed=77, site=0, eps=eps)
    _, s = _dal_fwd_cuda(h, x, scale, bias, out_dtype=bf16, save_s=True,
                         **kw)
    n_bytes = MAIN_ROWS * MAIN_H * 2 * 4
    fwd = dict(
        ms=time_ms(lambda: _dal_fwd_cuda(h, x, scale, bias, out_dtype=bf16,
                                         save_s=True, **kw)),
        plain_ms=time_ms(lambda: reference_dal_fwd(h, x, scale, bias,
                                                   out_dtype=bf16, **kw)),
        library_ms=None,
    )
    fwd["bound_ms"], fwd["bound_by"] = bound(n_bytes + 2 * MAIN_H * 4,
                                             16.0 * MAIN_ROWS * MAIN_H)
    bwd = dict(
        ms=time_ms(lambda: _dal_bwd_cuda(s, dy, scale, **kw)),
        plain_ms=time_ms(lambda: reference_dal_bwd(s, dy, scale, **kw)),
        library_ms=None,
    )
    bwd["bound_ms"], bwd["bound_by"] = bound(n_bytes + 3 * MAIN_H * 4,
                                             20.0 * MAIN_ROWS * MAIN_H)
    say(f"[kernels] dropout_add_layer_norm rows={MAIN_ROWS} H={MAIN_H} bf16 "
        f"rate {rate}, training forward: " + json.dumps(fwd))
    say(f"[kernels] dropout_add_layer_norm_bwd rows={MAIN_ROWS} H={MAIN_H}: "
        + json.dumps(bwd))
    say("[kernels] dropout_add_layer_norm(_bwd) library_ms null: no single "
        "PyTorch call computes dropout + residual add + LayerNorm")
    return dict(max_abs_err=worst, **fwd), dict(max_abs_err=worst, **bwd)


def mask_scale_phase(device, shapes=MASK_SHAPES, rate=DROPOUT_RATE) -> dict:
    """Kernel 5 against the plain generator, bit for bit, at the main
    path's shapes and ragged element counts, bf16 and float32."""
    import torch
    import torch.nn.functional as F

    from pytorch_distributed_training_tpu_torch.ops.dropout import (
        mask_scale,
        reference_mask_scale,
    )

    for i, shape in enumerate(shapes):
        for dtype in (torch.bfloat16, torch.float32):
            kw = dict(seed=500 + i, site=2)
            got = mask_scale(shape, rate, dtype, device=device, **kw)
            want = reference_mask_scale(shape, rate, dtype, device=device,
                                        **kw)
            if got.dtype != dtype or not torch.equal(got, want):
                raise AssertionError(f"mask_scale {shape} {dtype} differs "
                                     f"from the plain version")
    say(f"[kernels] mask_scale parity ok: {list(shapes)} x {{bf16, f32}}, "
        f"identical to the plain generator's mask-scale")
    probs = shapes[0]
    n = 1
    for d in probs:
        n *= d
    ones = torch.ones(probs, dtype=torch.bfloat16, device=device)
    kw = dict(seed=9, site=2, device=device)
    t = dict(
        ms=time_ms(lambda: mask_scale(probs, rate, torch.bfloat16, **kw)),
        plain_ms=time_ms(lambda: reference_mask_scale(probs, rate,
                                                      torch.bfloat16, **kw)),
        library_ms=time_ms(lambda: F.dropout(ones, rate, training=True)),
    )
    # ~25 integer operations an element (Philox4x32-10: 10 rounds of 2
    # mulhi, 2 mullo, 4 xor, 2 key adds per 4 elements, then the compare
    # and select), counted at the table's float32 rate
    t["bound_ms"], t["bound_by"] = bound(n * 2, 25.0 * n)
    say(f"[kernels] mask_scale {probs} bf16 rate {rate}: " + json.dumps(t))
    return dict(max_abs_err=0.0, **t)


# ------------------------------------------------------------ phase 4, 5


def expected_train_launches(*, micro: int, eval_batches: int,
                            layers: int) -> dict:
    """Launches of a counted train run: per microbatch forward the
    embeddings LN, 2 tails per layer and 2 + layers mask-scales
    (embeddings, classifier, the probs of each layer); per backward the
    LN and tail backwards and the probs masks again (attention_remat
    recomputes the core); per eval batch the forwards, deterministic."""
    return {
        "layer_norm": micro + eval_batches,
        "layer_norm_bwd": micro,
        "dropout_add_layer_norm": 2 * layers * (micro + eval_batches),
        "dropout_add_layer_norm_bwd": 2 * layers * micro,
        "mask_scale": (2 + 2 * layers) * micro,
    }


def train_once(argv, cli="train_dp"):
    """One run of the port's train_dp (or another trainer CLI of the port);
    returns (trainer, launch counts of this run, wall seconds)."""
    import importlib

    from pytorch_distributed_training_tpu_torch.ops import _build

    module = importlib.import_module(
        f"pytorch_distributed_training_tpu_torch.cli.{cli}")
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    trainer = module.train(argv)
    wall = time.perf_counter() - t0
    return trainer, dict(_build.LAUNCH_COUNTS), wall


def train_metrics(trainer, wall) -> dict:
    rec = trainer.history[-1]
    steps = len(trainer.step_log)
    return dict(
        wall_s=wall, steps=steps, samples_per_s=rec["samples_per_sec"],
        ms_per_step=1e3 * trainer.tcfg.global_batch_size
        / rec["samples_per_sec"],
        losses=[s["loss"] for s in trainer.step_log],
        grad_norms=[s["grad_norm"] for s in trainer.step_log],
        accuracy=rec["accuracy"], f1=rec["f1"],
    )


def train_phase(argv=TRAIN_ARGS) -> dict:
    """The training main path, counted (first run, cold), then a second
    run from the same seed that must give bit-identical per-step losses."""
    import torch

    from pytorch_distributed_training_tpu_torch.models.bert import (
        BertForSequenceClassification,
    )

    torch.cuda.reset_peak_memory_stats()
    trainer, counts, wall = train_once(argv)
    peak = torch.cuda.max_memory_allocated()
    tc, mc = trainer.tcfg, trainer.mcfg
    micro = trainer.state.step * tc.grad_accum_steps
    check_launches(
        f"train run ({trainer.state.step} steps x {tc.grad_accum_steps} "
        f"microbatches, {trainer.eval_loader.steps_per_epoch} eval batches)",
        counts, expected_train_launches(
            micro=micro, eval_batches=trainer.eval_loader.steps_per_epoch,
            layers=mc.num_layers),
    )
    cold = train_metrics(trainer, wall)
    if cold["steps"] != 3 or not all(
            map(math.isfinite, cold["losses"] + cold["grad_norms"])):
        raise AssertionError(f"train run: {cold}")
    # the weights of step 0, made again from the seed on the CPU
    start = BertForSequenceClassification(
        mc, generator=torch.Generator().manual_seed(tc.seed)
    ).state_dict()
    now = trainer.state.module.state_dict()
    unmoved = [k for k in start
               if torch.equal(now[k].cpu(), start[k])]
    if unmoved:
        raise AssertionError(f"parameters unchanged after 3 steps: "
                             f"{unmoved[:5]}")
    del trainer, start, now
    gc.collect()
    torch.cuda.empty_cache()
    cold.update(peak_mem_bytes=peak, launches=counts,
                layers=mc.num_layers, hidden=mc.hidden_size)
    say("[train] cold run: " + json.dumps(cold))
    trainer, _, wall = train_once(argv)
    warm = train_metrics(trainer, wall)
    # the eval alone once more, timed: the profile's busy share needs the
    # warm run's device-side seconds (steps + eval)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.evaluate()
    torch.cuda.synchronize()
    warm["eval_s"] = time.perf_counter() - t0
    warm["train_s"] = warm["steps"] * warm["ms_per_step"] / 1e3
    del trainer
    if warm["losses"] != cold["losses"]:
        raise AssertionError(f"per-step losses differ between two runs: "
                             f"{cold['losses']} vs {warm['losses']}")
    say("[train] warm run: " + json.dumps(warm))
    say("[train] per-step losses bit-identical across two runs")
    return dict(cold, warm=warm)


def train_profile_phase(warm, argv=TRAIN_ARGS, cli="train_dp",
                        tag="train-profile") -> dict:
    """Device kernel time of the 3 steps and the eval under
    ``torch.profiler``, by kernel class (the trainer is built first, so
    the weight copy to the card is outside the window), and its share of
    the warm run's step and eval seconds."""
    import importlib

    from torch.profiler import ProfilerActivity, profile

    module = importlib.import_module(
        f"pytorch_distributed_training_tpu_torch.cli.{cli}")
    trainer = module.build_trainer(module.build_parser().parse_args(argv))
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.run()
    wall = time.perf_counter() - t0
    del trainer
    res = dict(device_time_by_class(prof, warm["train_s"] + warm["eval_s"]),
               profiled_wall_s=wall, host=host_time_by_op(prof))
    say(f"[{tag}] " + json.dumps(res))
    return res


def host_time_by_op(prof, top_n=12) -> dict:
    """Host self time of a ``torch.profiler`` run by operator (the main
    thread and autograd's backward thread together), the largest first,
    and the number of kernel launches the host issued."""
    from torch.autograd import DeviceType

    ops = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CPU and "#" not in e.key]
    ops.sort(key=lambda e: -e.self_cpu_time_total)
    launches = sum(e.count for e in ops
                   if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                                "cuLaunchKernel", "cuLaunchKernelEx"))
    for e in ops[:top_n]:
        say(f"[train-profile] host {e.self_cpu_time_total / 1e3:9.3f} ms "
            f"{e.count:7d}x {e.key[:80]}")
    return dict(self_ms_total=sum(e.self_cpu_time_total for e in ops) / 1e3,
                runtime_launches=launches,
                top_self_ms={e.key[:60]: e.self_cpu_time_total / 1e3
                             for e in ops[:top_n]})


def cpu_vs_card_phase(argv=TINY_ARGS, cli="train_dp") -> dict:
    """The tiny preset with dropout on, 2 steps of accumulation 2 from one
    seed, on the CPU (plain versions) and on the card (kernels)."""
    metrics = lm_metrics if cli == "train_lm" else train_metrics
    runs = {}
    for device in ("cpu", "cuda"):
        trainer, _, _ = train_once(argv + ["--device", device], cli)
        runs[device] = metrics(trainer, 0.0)
        if trainer.mcfg.hidden_dropout <= 0 or len(trainer.step_log) != 2:
            raise AssertionError("cpu-vs-card wants dropout on and 2 steps")
    cpu, card = runs["cpu"], runs["cuda"]
    for key in ("losses", "grad_norms"):
        for a, b in zip(cpu[key], card[key]):
            if not math.isclose(a, b, rel_tol=CPU_CARD_RTOL):
                raise AssertionError(
                    f"cpu-vs-card {key}: cpu {cpu[key]} card {card[key]} "
                    f"(rtol {CPU_CARD_RTOL})")
    res = dict(cpu_losses=cpu["losses"], card_losses=card["losses"],
               cpu_grad_norms=cpu["grad_norms"],
               card_grad_norms=card["grad_norms"],
               max_rel_diff=max(abs(a - b) / abs(a) for a, b in zip(
                   cpu["losses"] + cpu["grad_norms"],
                   card["losses"] + card["grad_norms"])))
    say(f"[cpu-vs-card] {trainer.mcfg.num_layers}-layer "
        f"{argv[argv.index('--model') + 1]} ({cli}), dropout on, float32: "
        + json.dumps(res) + f" (rtol {CPU_CARD_RTOL})")
    return res


# ------------------------------------------------- phase 3, flash kernels


def flash_inputs(device, shape, dtype, *, seed, uniform=False):
    """q, k, v, dO as [B, N, S, D] views of [B, S, N, D] tensors (as the
    model hands them over) and the key-padding bias: row 1 ragged (two
    thirds of its keys), row 2 fully masked. ``uniform``: q = 0 and v, dO
    in [1, 1.5) (see FLASH_FP32_TOL)."""
    import torch

    from pytorch_distributed_training_tpu_torch.ops.attention import (
        make_attention_bias,
    )

    b, n, s, d = shape
    g = torch.Generator(device=device).manual_seed(seed)

    def bsnd(low=None):
        if low is None:
            return torch.randn(b, s, n, d, generator=g, device=device)
        return low + 0.5 * torch.rand(b, s, n, d, generator=g, device=device)

    q, k, v, do = bsnd(), bsnd(), bsnd(), bsnd()
    if uniform:
        q, v, do = torch.zeros_like(q), bsnd(1.0), bsnd(1.0)
    mask = torch.ones(b, s, dtype=torch.int32, device=device)
    mask[1, s * 2 // 3:] = 0
    mask[2] = 0
    bias = make_attention_bias(mask)
    return ([t.to(dtype).transpose(1, 2) for t in (q, k, v, do)], bias)


def check_flash_close(what, got, want, *, tol=None) -> float:
    """bf16: per element FLASH_BF16_ULPS bf16 ulps + FLASH_BF16_SLACK of
    the largest |want|; float32: ``tol`` absolute. Returns the largest
    error."""
    import torch

    g, w = got.detach().float(), want.detach().float()
    err = (g - w).abs()
    if tol is None:
        limit = (FLASH_BF16_ULPS * bf16_ulp(torch.maximum(g.abs(), w.abs()))
                 + FLASH_BF16_SLACK * float(w.abs().max()))
    else:
        limit = torch.full_like(err, tol)
    bad = err > limit
    if bad.any() or not torch.isfinite(g).all():
        raise AssertionError(
            f"{what}: {int(bad.sum())} of {err.numel()} elements beyond the "
            f"tolerance (max err {float(err.max())}): got "
            f"{g[bad][:4].tolist()} want {w[bad][:4].tolist()}")
    return float(err.max())


def flash_pair_parity(device, shape, whole, dtype, rate, seed,
                      uniform=False) -> float:
    """One pair's forward and gradients through ``flash_attention_base``
    (``torch.autograd.grad``) against the plain forward and backward on
    the same inputs; causal, key-padding bias, site 2."""
    import torch

    from pytorch_distributed_training_tpu_torch.ops import (
        flash_attention as fa,
    )

    (q, k, v, do), bias = flash_inputs(device, shape, dtype, seed=seed,
                                       uniform=uniform)
    kw = dict(causal=True, rate=rate, seed=seed, site=2)
    # the adapter's blocks at the main paths' shapes: the whole sequence,
    # or 512 of 1024
    block = shape[2] if whole else shape[2] // 2
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    o_k = fa.flash_attention_base(*leaves, bias, seed, dropout_rate=rate,
                                  causal=True, block_q=block, block_k=block,
                                  dropout_site=2)
    got = torch.autograd.grad(o_k, leaves, do)
    if whole:
        o_p = fa.reference_whole_fwd(q, k, v, bias, **kw)
        want = fa.reference_whole_bwd(q, k, v, bias, o_p, do, **kw)
    else:
        o_p, lse_p = fa.reference_flash_fwd(q, k, v, bias, **kw)
        want = fa.reference_flash_bwd(q, k, v, bias, o_p, lse_p, do, **kw)
        _, lse_k = fa.flash_fwd(q, k, v, bias, **kw)
        lerr = (lse_k - lse_p).abs()
        if bool((lerr > 1e-5 * lse_p.abs().clamp_min(1.0)).any()):
            raise AssertionError(f"flash_fwd lse {shape}: max err "
                                 f"{float(lerr.max())}")
    tol = FLASH_FP32_TOL if dtype == torch.float32 else None
    what = (f"{'flash_whole' if whole else 'flash'} {tuple(shape)} {dtype} "
            f"rate {rate}")
    worst = check_flash_close(what + " o", o_k, o_p, tol=tol)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        scale = 1.0 if tol is None else max(1.0, float(b.abs().max()))
        worst = max(worst, check_flash_close(
            f"{what} {name}", a, b, tol=None if tol is None else tol * scale))
    if o_k[2].abs().max() != 0 or not all(
            bool(torch.isfinite(t).all()) for t in got):
        raise AssertionError(f"{what}: the fully masked row is not 0, or a "
                             f"gradient is not finite")
    return worst


def flash_bounds(shape, whole, esize=2):
    """(fwd, bwd) least times: bytes each input read once and each output
    written once; operations 4 D (forward) and 10 D (backward: the QK^T
    recompute, dP, dV, dK, dQ) per causally visible (q, k) pair, at the
    bf16 tensor-core rate."""
    b, n, s, d = shape
    x = b * n * s * d * esize                     # one of q/k/v/o/dO/dq/...
    lse = 0 if whole else b * n * s * 4
    pairs = b * n * s * (s + 1) // 2
    fwd = bound(4 * x + lse + b * s * 4, 4.0 * d * pairs, BF16_FLOPS_PER_S)
    bwd = bound(8 * x + lse + b * s * 4, 10.0 * d * pairs, BF16_FLOPS_PER_S)
    return fwd, bwd


def flash_phase(device) -> dict:
    """Kernels 6-9: each pair bf16 at rates 0 and 0.1 and float32 at 0.1
    against its plain version, then kernel, plain and SDPA times at the
    main paths' shapes."""
    import torch
    import torch.nn.functional as F

    from pytorch_distributed_training_tpu_torch.ops import (
        flash_attention as fa,
    )

    res = {}
    for whole, shape in ((False, FLASH_BLOCKWISE), (True, FLASH_WHOLE)):
        names = (("flash_whole_fwd", "flash_whole_bwd") if whole
                 else ("flash_fwd", "flash_bwd"))
        worst = max(flash_pair_parity(device, shape, whole, torch.bfloat16,
                                      rate, 10 + i)
                    for i, rate in enumerate((0.0, DROPOUT_RATE)))
        worst32 = flash_pair_parity(device, shape, whole, torch.float32,
                                    DROPOUT_RATE, 20, uniform=True)
        say(f"[kernels] {names[0]}/{names[1]} parity ok: {list(shape)} "
            f"causal, ragged + fully masked rows; bf16 at rates 0 and "
            f"{DROPOUT_RATE}, max abs err {worst} (<= {FLASH_BF16_ULPS} bf16 "
            f"ulps + {FLASH_BF16_SLACK} x max|want|); float32 at rate "
            f"{DROPOUT_RATE}, uniform probs, max err {worst32} (<= "
            f"{FLASH_FP32_TOL} x max(1, max|want|): one differing mask "
            f"element would move o or dv by >= 1.1e-3)")

        (q, k, v, do), bias = flash_inputs(device, shape, torch.bfloat16,
                                           seed=30)
        kw = dict(causal=True, rate=DROPOUT_RATE, seed=30, site=2)
        qc, kc, vc, doc = (t.contiguous() for t in (q, k, v, do))
        if whole:
            o = fa.flash_whole_fwd(q, k, v, bias, **kw)
            fwd = lambda: fa.flash_whole_fwd(q, k, v, bias, **kw)  # noqa
            bwd = lambda: fa.flash_whole_bwd(q, k, v, bias, o, do, **kw)  # noqa
            pfwd = lambda: fa.reference_whole_fwd(q, k, v, bias, **kw)  # noqa
            pbwd = lambda: fa.reference_whole_bwd(  # noqa
                q, k, v, bias, o, do, **kw)
        else:
            o, lse = fa.flash_fwd(q, k, v, bias, **kw)
            fwd = lambda: fa.flash_fwd(q, k, v, bias, **kw)  # noqa
            bwd = lambda: fa.flash_bwd(q, k, v, bias, o, lse, do, **kw)  # noqa
            pfwd = lambda: fa.reference_flash_fwd(q, k, v, bias, **kw)  # noqa
            pbwd = lambda: fa.reference_flash_bwd(  # noqa
                q, k, v, bias, o, lse, do, **kw)
        lib = torch.ops.aten._scaled_dot_product_flash_attention(
            qc, kc, vc, 0.0, True)
        sdpa_fwd = lambda: F.scaled_dot_product_attention(  # noqa
            qc, kc, vc, is_causal=True)
        sdpa_bwd = lambda: (  # noqa
            torch.ops.aten._scaled_dot_product_flash_attention_backward(
                doc, qc, kc, vc, lib[0], lib[1], lib[2], lib[3], lib[4],
                lib[5], 0.0, True, lib[6], lib[7]))
        leaves = [t.detach().clone().requires_grad_() for t in (qc, kc, vc)]
        sdpa_train = lambda: torch.autograd.grad(  # noqa
            F.scaled_dot_product_attention(*leaves, is_causal=True), leaves,
            doc)
        (fb, fby), (bb, bby) = flash_bounds(shape, whole)
        plain_kw = dict(reps=5, inner=2)
        t_fwd = dict(ms=time_ms(fwd), plain_ms=time_ms(pfwd, **plain_kw),
                     library_ms=time_ms(sdpa_fwd), bound_ms=fb, bound_by=fby)
        t_bwd = dict(ms=time_ms(bwd), plain_ms=time_ms(pbwd, **plain_kw),
                     library_ms=time_ms(sdpa_bwd), bound_ms=bb, bound_by=bby,
                     sdpa_fwd_bwd_eager_ms=eager_ms(sdpa_train))
        say(f"[kernels] {names[0]} {list(shape)} bf16 causal rate "
            f"{DROPOUT_RATE}: " + json.dumps(t_fwd)
            + " (library: F.scaled_dot_product_attention(is_causal=True), "
              "no padding bias, no dropout)")
        say(f"[kernels] {names[1]} {list(shape)} bf16 causal rate "
            f"{DROPOUT_RATE}: " + json.dumps(t_bwd)
            + " (library: aten._scaled_dot_product_flash_attention_backward"
              " on SDPA's saved outputs)")
        res[names[0]] = dict(max_abs_err=max(worst, worst32), **t_fwd)
        res[names[1]] = dict(max_abs_err=max(worst, worst32), **t_bwd)
        del q, k, v, do, o, lib, leaves
        gc.collect()
        torch.cuda.empty_cache()
    return res


# ----------------------------------------------------------------- phase 6


def expected_lm_launches(*, micro: int, eval_batches: int, layers: int,
                         whole: bool) -> dict:
    """Launches of a counted LM run: per microbatch forward the LNs (2 a
    block + ln_f), the hidden-dropout masks (embeddings + 2 a block) and
    one flash forward a block; per backward the LN and flash backwards
    (the masks are saved, not redrawn); per eval batch the forwards,
    deterministic."""
    fwd, bwd = (("flash_whole_fwd", "flash_whole_bwd") if whole
                else ("flash_fwd", "flash_bwd"))
    lns = 2 * layers + 1
    return {
        fwd: layers * (micro + eval_batches),
        bwd: layers * micro,
        "layer_norm": lns * (micro + eval_batches),
        "layer_norm_bwd": lns * micro,
        "mask_scale": lns * micro,
    }


def lm_metrics(trainer, wall) -> dict:
    rec = trainer.history[-1]
    tc = trainer.tcfg
    return dict(
        wall_s=wall, steps=len(trainer.step_log),
        samples_per_s=rec["samples_per_sec"],
        tokens_per_s=rec["samples_per_sec"] * tc.max_seq_length,
        ms_per_step=1e3 * tc.global_batch_size / rec["samples_per_sec"],
        losses=[s["loss"] for s in trainer.step_log],
        grad_norms=[s["grad_norm"] for s in trainer.step_log],
        eval_loss=rec["eval_loss"], perplexity=rec["perplexity"],
        token_accuracy=rec["token_accuracy"],
    )


def lm_phase(argv, *, steps, rerun, tag) -> dict:
    """One counted ``train_lm`` run on gpt2-medium (finite losses; weights
    moved when ``steps`` > 1); with ``rerun``, a second from the same seed
    whose per-step losses must be bit-identical and a timed eval."""
    import torch

    from pytorch_distributed_training_tpu_torch.models.gpt2 import (
        GPT2LMModel,
    )
    from pytorch_distributed_training_tpu_torch.ops.flash_attention import (
        whole_seq,
    )

    torch.cuda.reset_peak_memory_stats()
    trainer, counts, wall = train_once(argv, "train_lm")
    peak = torch.cuda.max_memory_allocated()
    tc, mc = trainer.tcfg, trainer.mcfg
    seq = tc.max_seq_length
    whole = whole_seq(seq, seq, min(seq, 512), min(seq, 512))
    micro = trainer.state.step * tc.grad_accum_steps
    check_launches(
        f"{tag} run ({trainer.state.step} steps x {tc.grad_accum_steps} "
        f"microbatches, {trainer.eval_loader.steps_per_epoch} eval batches)",
        counts, expected_lm_launches(
            micro=micro, eval_batches=trainer.eval_loader.steps_per_epoch,
            layers=mc.num_layers, whole=whole),
    )
    cold = lm_metrics(trainer, wall)
    if cold["steps"] != steps or not all(map(
            math.isfinite,
            cold["losses"] + cold["grad_norms"] + [cold["eval_loss"]])):
        raise AssertionError(f"{tag} run: {cold}")
    # the warmup schedule's learning rate is 0 at update 1, so only a run
    # of more than one step can move the weights
    if steps > 1:
        start = GPT2LMModel(
            mc, generator=torch.Generator().manual_seed(tc.seed)
        ).state_dict()
        now = trainer.state.module.state_dict()
        unmoved = [k for k in start if torch.equal(now[k].cpu(), start[k])]
        if unmoved:
            raise AssertionError(f"{tag}: parameters unchanged after "
                                 f"{steps} steps: {unmoved[:5]}")
        del start, now
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    cold.update(peak_mem_bytes=peak, launches=counts, layers=mc.num_layers,
                hidden=mc.hidden_size, seq=seq,
                attention="whole-sequence flash" if whole
                else "blockwise flash")
    say(f"[{tag}] cold run: " + json.dumps(cold))
    if not rerun:
        return cold
    trainer, _, wall = train_once(argv, "train_lm")
    warm = lm_metrics(trainer, wall)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.evaluate()
    torch.cuda.synchronize()
    warm["eval_s"] = time.perf_counter() - t0
    warm["train_s"] = warm["steps"] * warm["ms_per_step"] / 1e3
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    if warm["losses"] != cold["losses"]:
        raise AssertionError(f"{tag}: per-step losses differ between two "
                             f"runs: {cold['losses']} vs {warm['losses']}")
    say(f"[{tag}] warm run: " + json.dumps(warm))
    say(f"[{tag}] per-step losses bit-identical across two runs")
    return dict(cold, warm=warm)


# ------------------------------------------------------------------- main


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU visible (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from pytorch_distributed_training_tpu_torch.ops import _build

    # one stream throughout; pinned all the same for cuBLAS's determinism
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    t0 = time.perf_counter()
    laps = {}

    def lap(name):
        laps[name] = round(time.perf_counter() - t0 - sum(laps.values()), 1)

    smi = device_phase()
    build_phase()
    lap("build")
    res = {"layer_norm": layer_norm_phase(device),
           "paged_attention": paged_phase(device),
           "layer_norm_bwd": ln_bwd_phase(device),
           "mask_scale": mask_scale_phase(device)}
    res["dropout_add_layer_norm"], res["dropout_add_layer_norm_bwd"] = (
        dal_phase(device))
    lap("kernels")
    res.update(flash_phase(device))
    lap("flash kernels")
    train = train_phase()
    lap("train")
    train_profile_phase(train["warm"])
    lap("train-profile")
    cpu_vs_card_phase()
    lm = lm_phase(LM_1024_ARGS, steps=3, rerun=True, tag="lm-1024")
    lap("lm-1024")
    train_profile_phase(lm["warm"], LM_1024_ARGS, "train_lm",
                        tag="lm-1024-profile")
    lap("lm-1024-profile")
    lm_short = lm_phase(LM_128_ARGS, steps=1, rerun=False, tag="lm-128")
    cpu_vs_card_phase(TINY_LM_ARGS, "train_lm")
    lap("lm-128 + cpu-vs-card")
    serve = serve_phase()
    full_sequence_phase(device, serve.pop("streams"), PROMPTS)
    profile_phase(serve["warm"])
    lap("serve")
    say("[done] seconds by phase " + json.dumps(laps))

    kernels = []
    # each kernel's launches from the main path that runs it
    runs = dict(paged_attention=serve, flash_fwd=lm, flash_bwd=lm,
                flash_whole_fwd=lm_short, flash_whole_bwd=lm_short)
    for name in _build.KERNELS:
        r = res[name]
        launches = runs.get(name, train)["launches"].get(name, 0)
        kernels.append(dict(
            name=name, route="cuda",
            source="pytorch_distributed_training_tpu_torch/csrc/"
                   + _build.KERNEL_SOURCES[_build.KERNELS[name]],
            replaces=REPLACES[name], launches=launches,
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            parity="pass",
        ))
    say(f"[done] {time.perf_counter() - t0:.1f} s on {smi}")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
