#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (one NVIDIA GPU).

    python3 chip_smoke.py

Drives ``pytorch_distributed_training_tpu_torch`` only (never JAX, nothing of
the JAX package), in phases that each raise on failure:

1. device: a CUDA GPU must be visible; prints ``nvidia-smi``'s name and
   power limit;
2. build: compiles every CUDA kernel of the serving path from
   ``pytorch_distributed_training_tpu_torch/csrc`` with ``nvcc`` for
   ``sm_90a``, one process per source, all at once;
3. kernels: holds each kernel against its plain PyTorch version on the
   card (tolerances below), and times kernel, plain version and the
   library yardstick at the serving shapes with CUDA events;
4. serve: runs the port's ``serve_lm`` main on gpt2-medium at full width
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
import io
import json
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

REPLACES = {
    "layer_norm": "pytorch_distributed_training_tpu/ops/layer_norm.py:102",
    "paged_attention":
        "pytorch_distributed_training_tpu/ops/paged_attention.py:238",
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


def bound(n_bytes: float, flops: float) -> tuple[float, str]:
    """Least time for the work on the card, in ms, and what bounds it."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def bf16_ulp(x):
    import torch

    a = x.abs().float().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


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
            err = (got.float() - want.float()).abs()
            tol = bf16_ulp(torch.maximum(got.float().abs(),
                                         want.float().abs())) + LN_FP32_SLACK
            bad = err > tol
            if bad.any() or not torch.isfinite(got.float()).all():
                raise AssertionError(
                    f"layer_norm rows={n} {in_dtype}: {int(bad.sum())} "
                    f"elements beyond 1 bf16 ulp + {LN_FP32_SLACK}: got "
                    f"{got.float()[bad][:4].tolist()} want "
                    f"{want.float()[bad][:4].tolist()}"
                )
            worst = max(worst, float(err.max()))
    say(f"[kernels] layer_norm parity ok: rows {list(rows)} x "
        f"{{bf16, f32}} in -> bf16 out, max abs err {worst} (<= 1 bf16 "
        f"ulp + {LN_FP32_SLACK} per element)")

    timings = {}
    for n in (serve_rows, 128, 4096):
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
    return dict(max_abs_err=worst, **timings[serve_rows])


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


# ---------------------------------------------------------------- phase 4


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

    from pytorch_distributed_training_tpu_torch.ops import _build

    torch.cuda.reset_peak_memory_stats()
    events, stats, counts, wall = serve_once(argv, prompts, new_tokens)
    toks = streams(events, prompts, new_tokens)
    peak = torch.cuda.max_memory_allocated()
    prefills, ticks = stats["admitted"], stats["decode_dispatches"]
    want = {"layer_norm": (2 * n_layers + 1) * (prefills + ticks),
            "paged_attention": n_layers * ticks}
    for name in _build.KERNEL_SOURCES:
        if counts.get(name, 0) == 0 or counts[name] != want[name]:
            raise AssertionError(
                f"{name}: {counts.get(name, 0)} launches in the serve run, "
                f"want {want[name]} ({prefills} prefills, {ticks} ticks)"
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


def _kernel_class(name: str) -> str:
    if "layer_norm_fwd_kernel" in name:
        return "layer_norm (port kernel)"
    if "paged_decode_kernel" in name:
        return "paged_attention (port kernel)"
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
    from torch.autograd import DeviceType
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
    by_class: dict[str, float] = {}
    top = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = float(getattr(e, "self_device_time_total", 0.0))
        cls = _kernel_class(e.key)
        by_class[cls] = by_class.get(cls, 0.0) + us
        top.append((us, e.count, e.key[:90]))
    total_us = sum(by_class.values())
    engine_s = warm["prefill_s"] + warm["decode_s"]
    res = dict(
        device_kernel_ms=total_us / 1e3,
        busy_share_of_warm_engine_time=(
            total_us / 1e6 / engine_s if engine_s else None
        ),
        by_class_ms={k: v / 1e3 for k, v in sorted(
            by_class.items(), key=lambda kv: -kv[1])},
    )
    say("[profile] " + json.dumps(res))
    for us, count, name in sorted(top, reverse=True)[:10]:
        say(f"[profile] {us / 1e3:9.3f} ms {count:6d}x {name}")
    return res


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


# ------------------------------------------------------------------- main


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU visible (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from pytorch_distributed_training_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    t0 = time.perf_counter()
    smi = device_phase()
    build_phase()
    ln = layer_norm_phase(device)
    pa = paged_phase(device)
    serve = serve_phase()
    full_sequence_phase(device, serve.pop("streams"), PROMPTS)
    profile_phase(serve["warm"])

    kernels = []
    for name, res in (("layer_norm", ln), ("paged_attention", pa)):
        kernels.append(dict(
            name=name, route="cuda",
            source="pytorch_distributed_training_tpu_torch/csrc/"
                   + _build.KERNEL_SOURCES[name],
            replaces=REPLACES[name], launches=serve["launches"][name],
            max_abs_err=res["max_abs_err"], ms=res["ms"],
            plain_ms=res["plain_ms"], bound_ms=res["bound_ms"],
            bound_by=res["bound_by"], library_ms=res["library_ms"],
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
