#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (one NVIDIA GPU).

    python3 chip_smoke.py

Drives ``pytorch_distributed_training_tpu_torch`` only (never JAX, nothing of
the JAX package), in phases that each raise on failure:

1. device: a CUDA GPU must be visible; prints ``nvidia-smi``'s name and
   power limit, and the top SM clock that sets the integer rate of the
   bounds;
2. build: compiles every CUDA source of the port from
   ``pytorch_distributed_training_tpu_torch/csrc`` with ``nvcc`` for
   ``sm_90a``, one process per source, all at once (the LayerNorm,
   dropout-add-LayerNorm and dropout libraries may not spill), and counts
   the Philox mask's integer instructions an element by pipe in their
   SASS (``cuobjdump``);
3. kernels: holds each kernel against its plain PyTorch version on the
   card (tolerances below; the dropout masks bit for bit), backward kernels
   through ``torch.autograd.grad`` (the LayerNorm pair and the
   dropout-add-LayerNorm pair also at H 64-2048 and 1001, bf16 and float32
   in and out, on rows off 16 bytes, two calls bit-identical; the latter
   also at rate 0 and without s; kernel 5's mask-only and apply modes on
   x off 16 bytes and holding NaN and infinities, and the gradient through
   ``raw_dropout``), and times kernel, plain version and the
   library yardstick at the main paths' shapes with CUDA-graph replay (the
   flash kernels against ``F.scaled_dot_product_attention``, at dropout
   rates 0.1 and 0, the backwards' kernels one by one; the whole-sequence
   pair also alone at other head dims and lengths; the tensor-core
   kernels' masks bit for bit, and the two-pass dk/dv kernel's gradients
   equal to the fused kernel's; the single-query paged kernel on bf16 and
   float32 pools at head dims 32-256 and one whose rows are no multiple
   of 16 bytes, two calls bit-identical, timed at the serve and parity
   shapes against SDPA on the gathered K/V; the
   multi-query paged kernel at q_len 1-64 over lengths on and off page
   boundaries and of its 16-row tiles, also at head dims 32-256 and 50,
   two calls bit-identical, timed at the verify and chunk shapes against
   SDPA on the gathered K/V; both paged kernels again on int8 pools with
   bf16 and float32 q; the two-pass flash backward also against the fused
   kernel's gradients); ``dropout-modes``: kernel 5's bits8 and exact
   modes (the ``"bits8"`` and ``"exact"`` streams) bit for bit against
   their plain versions at the mask parity shapes, on x aligned and off
   16 bytes holding NaN and infinities, bf16 and float32, two calls
   bit-identical, the NaN contract (exact drops a NaN to 0, bits8 keeps
   it), ``raw_dropout``'s output and gradient, each timed at the apply
   shapes beside the plain version and ``F.dropout``, its bound from this
   build's SASS; then ``int8-gemm``: ``ops/quant.int8_mm``
   (``torch._int_mm``, the int8 training's products; a library call, as
   XLA's int8 ``dot_general`` is no Pallas kernel) at bert-large's six
   dense sites at 1024 tokens and a shape it pads (5 x 60 x 36), forward,
   dgrad and wgrad, bit-equal to the exact (float64) product, timed
   beside the bf16 ``torch.matmul``;
4. train: runs the port's ``train_dp`` on bert-large-cased at full width
   and depth (3 optimizer steps of 96 = 8 x 12 on the synthetic MRPC task,
   then the full 408-row eval), with the launch counters reset just before
   and read just after and checked against the counts the step derives
   (no plain mask-scale tensor made: every dropout site applies its mask
   in the kernel);
   finite losses, moved parameters, bit-identical per-step losses in a
   second run; a third run, of one step and the eval, under
   ``torch.profiler``; then the same for
   ``train_mp``'s main path, the TriBert ensemble of bert-base-cased x 3
   branches (the launches of every branch's layers counted, the three
   branches started unlike each other and every one moved); then
   ``train-int8``: ``train_dp`` on bert-large at full width and depth, 2
   steps of 48 = 8 x 6 and a 32-row eval, native and with
   ``--matmul-impl int8``, ``int8_full`` and ``int8_full --quant-delayed
   --quant-delayed-grads`` (the calibration's forwards and backwards
   counted with the rest), each counted, finite, every parameter moved,
   step 1's loss within INT8_LOSS_ATOL of native's, its ms a step beside
   native's, the last variant run twice with bit-identical losses, the
   second time with a checkpoint a step (in a temporary directory,
   removed after), then resumed from its step 1: step 1's amaxes
   restored, no calibration launch, step 2's loss, grad norm and every
   weight bit-equal; ``roberta-mnli``: ``train_dp --model roberta-large
   --task mnli`` at the recipe (96 = 8 x 12, seq 128, bf16, dropout 0.1,
   seed 42; the synthetic 3-class fallback through a stand-in
   ``datasets`` module that raises ``ConnectionError``, in this script
   only), 2 steps and 96 rows of each validation split, the train
   phase's checks (counted with the pooler's pre-dropout and both
   splits' eval batches, a rerun bit-identical), its samples/s, ms a
   step, peak memory and both accuracies; ``dropout-streams``:
   roberta-large through ``model_preset`` overrides, 1 step of 96 and 32
   rows a split, under ``bits32``, ``bits8`` and ``exact`` and under
   ``layernorm_impl="reference"``: counted (``stream_launches``: no
   kernel 3 or 4 in the train step, the stream's mode of kernel 5,
   kernels 1 and 2 or none), finite losses bit-equal on a rerun;
   ``telemetry-faults``: the roberta-mnli run with ``--metrics-dir``,
   its stream read back (a record a step with its device block), ms a
   step beside the run without, losses equal; then the tiny preset
   under ``PDT_TPU_FAULT=crash_at_step:1`` and ``--max-restarts 1`` with
   a fresh ``--checkpoint-dir``: one restart in the same process, the
   resumed run's step 2 loss and every weight bit-equal to the
   uninterrupted run's;
5. cpu-vs-card: the ``tiny`` preset with dropout on, trained 2 steps on
   the CPU (plain versions) and on the card (kernels) from one seed: the
   per-step losses agree, so the card's masks are the plain generator's;
   then the same for 3 tiny branches through ``train_mp`` on the
   whole-sequence flash kernels (the card runs' launches counted), and
   ``train_mp --mp-mode stage`` at world size 1 against ``train_dp`` on
   the card (the same per-step losses, bit for bit), and ``--mp-mode
   pipeline`` and ``--mp-mode 1f1b`` at micro 8 in 4 pipeline
   microbatches against ``--mp-mode stage`` at micro 2 (the same per-step
   losses and grad norms, bit for bit); ``cpu-vs-card-int8``: the tiny
   preset at ``int8_full --quant-delayed --quant-delayed-grads`` on the
   CPU and the card, the losses within INT8_CPU_CARD_RTOL; then
   ``train-pipeline``:
   ``train_mp`` on bert-base-cased at full width, 2 steps of the recipe's
   96 = 8 x 12 and a 96-row eval, through ``--mp-mode pipeline`` and
   ``--mp-mode 1f1b`` (4 pipeline microbatches of 2 rows an accumulation
   microbatch: 48 a step) and ``--mp-mode stage``, each counted against
   the launches its microbatches derive, its losses finite and every
   parameter moved, its ms a step, the peak memory of its train steps and
   its ``pipeline_bubble`` printed; later the same for
   ``gpt2-tiny`` through ``train_lm`` (the whole-sequence flash
   kernels);
6. lm: runs the port's ``train_lm`` on gpt2-medium at full width and
   depth, at seq 1024 (3 optimizer steps of 32 = 4 x 8, then a 64-row
   eval: the blockwise flash kernels) and at seq 128 (1 step of 96 = 8 x
   12, then a 32-row eval: the whole-sequence pair), the launch counters
   reset just before each and read just after and checked against the
   counts the step derives; finite losses, moved parameters, bit-identical
   per-step losses in a second seq-1024 run, and a third, of one step
   and the eval, under ``torch.profiler``; then the seq-1024 run again with
   ``PDT_FLASH_TWO_PASS=1`` (the two-pass backward kernels counted, step
   1's loss bit-identical to the fused run's, later steps within 1e-3),
   and once more, one step, under ``torch.profiler``; the seq-128 run
   also once more under ``torch.profiler``; no LM profile may hold an FMA
   flash kernel (they take float32 only); ``lm-1024-int8``: the seq-1024
   run at ``--matmul-impl int8_full``, 1 step and the eval, counted. Every
   LM run takes
   ``train_lm``'s defaults: the scanned trunk, FSDP over an fsdp axis of
   one process (unwrapped). Then ``lm-scan-equal``: the tiny LM with
   dropout on, scanned and ``--no-scan-layers``, the same per-step losses
   bit for bit and the same launches, grad norms and weights within
   1e-6; and ``lm-fsdp``: in a process of its own with a one-process
   NCCL group, gpt2-medium at seq 1024 for 2 steps + the eval, unwrapped,
   then sharded with FSDP2 by the placements of an fsdp axis of 2 on a
   one-rank device mesh (FSDP2's unshard and reshard of every unit, at
   one rank device copies in place of the all-gather and reduce-scatter,
   and AdamW on DTensor shards, on the card), counted, its losses within
   1e-4 of the unwrapped run's, and its first step and the eval once
   more under ``torch.profiler`` (the device time of FSDP's ranges and of
   any collective); ``remat``: gpt2-medium at lm-1024's shape, 2 steps
   without remat, with ``--remat`` under each ``--remat-policy`` and with
   ``--remat-mlp``, each counted (the recomputed forwards' launches
   included), the losses bit-equal to no remat's and the grad norms
   within TWO_PASS_RTOL, the ms a step and the train steps' own peak
   memory (reset after the trainer is built, read before the eval), then
   micro 8 without remat and with ``--remat-mlp``. Then
   tensor and context parallelism (one card is world size 1, so their
   collectives run only over gloo on the CPU): ``tp-split``, one
   gpt2-medium block at lm-1024's shape in bf16 with the flash kernels,
   cut by ``parallel/sharding.tensor_parallel`` into model-2 and model-4
   slices, each slice's forward and backward run in this process with
   the row-parallel partials summed as the all-reduce sums them, output,
   input gradient and every weight gradient (re-assembled) against the
   whole block's, and a slice's ms beside the whole block's; ``ring``,
   ring attention at lm-1024's attention shape in bf16, causal, the
   sequence cut into 2 and 4 shards driven in turn in this process,
   forward and q/k/v gradients against ``reference_attention``, rate 0.1
   finite, alike twice and keeping 0.9 of the probabilities within 1%,
   its ms beside kernels 6 + 9 and reference attention at that shape;
   ``tp-cp-equal``, ``train_lm`` on the tiny LM with ``--tp
   --no-scan-layers`` against without ``--tp``, with ``--attention
   ring`` against ``--attention reference`` (JAX's fallback at a seq axis
   of 1), and ``train_dp --attention ring`` against ``reference``, the
   steps and eval metrics bit for bit and the launches equal;
   ``mp-cp``, ``train_mp --mesh-seq 2`` under the branch and pipeline
   modes, one after the other in two gloo processes on the card (tiny,
   float32, dropout off),
   both exiting 0 with the losses and grad norms of one process at seq 1
   (reference attention) within MP_CP_RTOL, and the host µs of one
   gloo ``all_reduce_max`` of a scalar on the card; then
   ``serve-tp-block``: one gpt2-medium serving block (bf16, and int8
   weights quantized whole with int8 pools) cut by
   ``serve_param_specs`` into model-2 and model-4 slices, each on its own
   pools at 8 or 4 heads, one decode tick of 8 slots at the serve
   contexts (the decode kernel) and one verify of 5 rows (the multi-query
   kernel), the row-parallel partials summed here: the output and every
   slice's pool writes against the whole block's, the slices' launches,
   and the device ms of a slice's dispatch beside the whole block's;
7. serve: runs the port's ``serve_lm`` main on gpt2-medium at full width
   (random weights from ``--seed 0``) over a JSONL request stream, with the
   kernels' launch counters reset just before and read just after; checks
   every request's token count, the launch counts against the engine's
   prefill and decode counts, greedy streams identical across two runs, and
   each served token against a full-sequence forward of the same model;
   a further run under ``torch.profiler`` breaks the device time down by
   kernel class;
8. serve options (the first 8 prompts, 16 new tokens a request, from
   here on to serve-tp): ``serve_lm``
   again with ``--spec-k 4`` (its profiled second run must give the
   same greedy streams), ``--prefill-chunk 32`` and
   ``--prefix-cache`` (8 prompts sharing a 4-page prefix, two of them
   copying a page on write), each counted against the engine's verify,
   chunk and decode dispatches, the pages left equal to those the prefix
   cache holds, every served token checked against the full-sequence
   forward, the speculative run once more under ``torch.profiler``
   (kernel 13's share of the device time; its float32 FMA kernel may not
   appear); then int8
   serving, ``--weights-dtype int8 --kv-dtype int8``
   plain (profiled), with ``--spec-k 4`` and with ``--prefix-cache``, and
   ``--weights-dtype int8`` alone, each counted (the int8-pool kernels
   only) and checked against a full-sequence forward on the same
   dequantized weights; one decode dispatch of the float and the int8
   engine, its kernels counted and its host time taken in turns; on the
   float engine a dispatch at a shape its warm-up did not see raising
   ``RecompileError``, a sync inside an armed ``transfer_scope`` raising
   ``TransferGuardError`` and the same sync on another thread neither
   raising nor counted, then the dispatch timed with the runtime guards
   ``off`` and in ``record`` mode in turns; then
   ``serve-tp``: ``serve_lm --tp 2 --warmup``, plain and with int8
   weights and KV,
   as two processes on the one card (each makes its own gloo group, as
   NCCL takes one rank a device), the option runs' requests: rank 0's
   streams (counted against tp=1's, and checked against the
   full-sequence forward with the others), ``stats()["tp"]``, the page
   count of tp=1, 8 heads in each rank's pools, each rank's launches
   against the leader's dispatch counts (the warm-up's added), the
   follower's calls, each rank's collective audit of the decode step (2 x
   24 all-reduces, clean against ``serve_tp_manifest``), both exits 0;
   ``serve-dense-host``: ``serve_lm --kv-layout dense --sampling
   host`` on the serve phase's prompts (kernel 1 only, counted; greedy
   streams through the margin gate) and one fixed-seed sampled request,
   the same through the dense layout with device sampling and through
   the paged layout, all three equal, each sampled stream through the
   sampled margin gate (``sampled_margin_check``);
   ``serve-tenant``: two tenants at a quarter of the pool each behind the
   prefix cache, 16 long prompts on a shared prefix in the batch lane and
   16 short ones in the interactive lane, queued at once: every request
   done, no page exhaustion, the quota holding the flood, the first lane
   cycle 4 interactive then 1 batch and at least 4/5 of the contended
   admissions interactive, counted, the streams through the margin gate;
9. checkpoints and generation (in a temporary directory, removed after):
   ``ckpt-resume``, ``train_lm`` on gpt2-medium at full width and depth,
   seq 128, 2 steps with ``--checkpoint-every-steps 1``, then with step
   2 taken away a run resumed from step 1 (counted) whose step 2 loss,
   grad norm and every weight equal the uninterrupted run's bit for bit
   (the bytes a step, save and restore seconds printed); ``ckpt-int8``,
   the tiny preset at ``int8_full`` with delayed scales on both passes
   resumed the same way, counted from its construction (no calibration
   launch), bit-equal; ``generate``, ``generate_lm --checkpoint-dir`` on
   that checkpoint (scanned, so re-laid out) over the serve phase's 12
   prompts and 32 greedy tokens, the library call counted (kernel 1 at
   2 a block + ln_f a forward, one prefill and 31 decode steps) and
   timed (ms a decode step: its wall less a 1-token call's, over the 31
   decode steps), and ``--hf-checkpoint`` on a ``pytorch_model.bin`` of
   the same weights under GPT-2's HF names giving the same streams;
   ``serve-ckpt``, ``serve_lm --checkpoint-dir`` on it, counted, with
   ``stats()["weights_step"]`` 2; ``serve-draft``, ``serve_lm
   --checkpoint-dir --spec-k 4`` on it with the n-gram drafter and with
   ``--draft-checkpoint`` on the same checkpoint (``--draft-model
   gpt2-medium``: the draft lane, the base as its own draft), counted
   (the draft chains' kernel-12 and kernel-1 launches), acceptance above
   0.9, the ms a tick of both; every generated and served token within
   the margin gate of a full-sequence forward of the checkpoint's
   weights; then the newest step's largest file damaged (same length)
   and a digest restore falling back to step 1. ``lm-fsdp`` (phase 6)
   also saves its sharded state and restores it into the unwrapped
   model, bit-equal.
10. fleet: ``fleet_lm --replicas 2`` at the serve phase's shape (8 slots,
   buckets 16-128, page 16, seed 0; each replica a ``serve_lm`` process
   on the card, running kernels 1 and 12), booted beside the checkpoint
   checks; 12 greedy prompts through the router while
   ``PDT_TPU_FAULT=replica_crash:1@1`` kills replica 1 mid-load: every
   request ``done`` or an explicit retryable error, every ``done`` stream
   equal to the serve phase's token for token, at least one failover;
   replica 1 respawned (during the full-sequence checks) with one restart
   burned, the pool back to 2 up; SIGTERM while a 64-token stream runs
   on replica 0: the stream ends ``done``, ``fleet_lm`` exits 0, the
   replicas 75 after a ``sigterm_drain`` flight dump and a ``preemption``
   record. Prints the boot seconds, TTFT p50 through the router beside
   the serve phase's, replica 0's first TTFT without ``--warmup``,
   requests/s and the seconds to recovery.

The runtime guards (``analysis/guards.py``) run strict in every
``serve_lm`` run, which must end with 0 recompiles and 0 implicit
transfers, and in the train phases' runs (``strict_guards``), which also
show the warm start's ``compile`` record and their sharding and
first-step collective audits ok; lm-fsdp shows its audits, and
telemetry-faults the records' order (the audits and the ``compile``
record before the first step).

Prints one ``kernels`` JSON line (18 kernels; kernel 5's mask-only mode,
``mask_scale``, is on no main path since its apply mode,
``mask_scale_apply``, took every dropout site, so its launches are 0;
its bits8 and exact modes, ``dropout_bits8`` and ``dropout_exact``, with
the dropout-streams runs' launches) and, last, ``{"ok": true,
"device": ...}``.
Exits non-zero, with no result, when no CUDA GPU is visible or any phase
fails.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet (dense): HBM3 rate, and the float32 rate
# outside the tensor cores, where these kernels do their arithmetic
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# 32-bit integer results a clock per SM on compute capability 9.0 (CUDA C++
# Programming Guide, arithmetic instruction throughput): multiply and
# multiply-add (IMAD*, the FMA-heavy pipe) and add, logic, compare, select
# and shifts (the ALU pipe) each run at 64, where float32 FMA runs at 128;
# times the SMs and the card's top SM clock (int_instr_per_s)
INT_RESULTS_PER_CLOCK_SM = 64
# Integer instructions an element of the Philox mask, (FMA-heavy pipe, ALU
# pipe), as sass_per_element counts them in cuobjdump -sass of the
# libraries ops/_build.py builds (CUDA 12.8's nvcc for sm_90a, on an
# NVIDIA H100 80GB HBM3; the build phase prints the counts of its own
# build beside these): the loop that draws a chunk's Philox groups, over
# its elements (kernel 5's main loop, a chunk of 8 bf16, with its load,
# multiply and store; kernels 3 and 4's mask loop, a chunk of 8). A group
# of four is 18 IMAD.WIDE.U32 and ~20 LOP3 (round 0 folds), the rest the
# compare, select and addressing. The bound takes the busier pipe.
PHILOX_INT_PER_ELEMENT = {
    "mask_scale": (5.0, 7.0),
    "mask_scale_apply": (5.75, 7.75),
    "dal_fwd": (5.125, 7.75),
    "dal_bwd_dx": (4.875, 8.0),
}
# (library, symbol pattern in cuobjdump's mangled names, elements an
# iteration of the loop counted[, an opcode the loop must hold]) of each
# entry above: the main path's instantiations (bf16; rows of 1024 at H
# 1024 for kernels 3 and 4)
SASS_LOOPS = {
    "mask_scale": ("dropout", r"dropout_kernelI13__nv_bfloat16jLi0EE", 8),
    "mask_scale_apply": ("dropout", r"dropout_kernelI13__nv_bfloat16jLi1EE",
                         8),
    # kernel 5's bits8 (a unit of 16, one Philox block) and exact modes,
    # whose bounds take the counts of this run's build (SASS_MEASURED)
    "dropout_bits8": ("dropout", r"dropout_kernelI13__nv_bfloat16jLi2EE", 16,
                      "STG.E.128"),
    "dropout_exact": ("dropout", r"dropout_kernelI13__nv_bfloat16jLi3EE", 8,
                      "STG.E.128"),
    "dal_fwd": ("dropout_add_layer_norm",
                r"dal_fwd_kernelI13__nv_bfloat16S\w*Li8ELi4ELb1E", 8),
    "dal_bwd_dx": ("dropout_add_layer_norm",
                   r"dal_bwd_dx_kernelI13__nv_bfloat16Li8ELi4ELb1E", 8),
}
# sass_per_element of each SASS_LOOPS entry in this run's build (the build
# phase fills it); the bounds of entries PHILOX_INT_PER_ELEMENT lacks
SASS_MEASURED: dict = {}
# SASS opcodes (before the first dot) by pipe, as sass_per_element counts
SASS_FMA_HEAVY = ("IMAD", "IMUL")
SASS_ALU = ("LOP3", "ISETP", "SEL", "FSEL", "IADD3", "SHF", "LEA", "PRMT",
            "FSETP", "IMNMX", "FMNMX")

LN_HIDDEN = 1024
# kernel 1's parity rows (either side of its few-rows plan, 256) and
# widths: the tiny and bert-base presets, gpt2-medium/bert-large, the
# widest row, and one no multiple of 8 (single-element chunks)
LN_ROWS = (4, 16, 128, 300, 4096)
LN_WIDTHS = (64, 768, 1024, 2048, 1001)
# LayerNorm tolerance per element: 1 bf16 ulp of the element, plus the
# float32 difference of two summation orders and rsqrt roundings before the
# cast (a few float32 ulps of unit-scale terms), which alone can move an
# output near zero by many of its own tiny ulps
LN_FP32_SLACK = 2.0 ** -16
PAGED = dict(heads=16, head_dim=64, page_size=16)  # one sequence a length
PAGED_LENGTHS = (1, 15, 16, 17, 300, 1024, 64, 513)
PAGED_TOL = 2e-2          # atol = rtol, bf16 output vs float32 plain version
# kernel 12 (float and int8 pools) also at other head dims: 16-byte loads
# with 1 to 32 lanes a row (32, 96, 128, 256) and, for 50, a row that is
# no multiple of 16 bytes in any pool dtype (the scalar-load instantiation)
PAGED_HEAD_DIMS = (32, 96, 128, 256, 50)
# decode tick of the serve phase: 8 slots, block-table rows of
# (128 + 64) / 16 pages, contexts of prompts up to 120 bytes + 32 tokens
SERVE_CONTEXTS = (17, 33, 48, 65, 90, 120, 140, 152)
SERVE_WINDOWS = 12
# kernel 13: query blocks of the verify (spec_k 4 + 1) and chunk (32)
# dispatches, and parity lengths on and off page boundaries (each q_len
# also at lengths q_len and q_len + 1); the verify run's block-table rows
# hold ceil((128 + 64 + 4) / 16) pages. q_len 17 and 33 span a boundary
# of the kernel's 16-row tiles.
PAGED_MQ_QLENS = (1, 2, 5, 16, 17, 32, 33, 64)
PAGED_MQ_LENGTHS = (15, 16, 17, 300, 1024)
# kernel 13 (float and int8 pools) also at PAGED_HEAD_DIMS, at these q_lens
PAGED_MQ_HEAD_DIM_QLENS = (5, 17, 32)
VERIFY_Q, VERIFY_WINDOWS = 5, 13
CHUNK_Q, CHUNK_CONTEXTS = 32, (32, 64, 96, 128, 160)
# kernels 12 and 13 on int8 pools: float32 out against the plain int8
# version within 1e-5 x max(1, max|want|) (float32 sums in another order)
PAGED_INT8_TOL = 1e-5

SERVE_ARGS = ["--model", "gpt2-medium", "--device", "cuda", "--seed", "0",
              "--num-slots", "8", "--prompt-buckets", "16,32,64,128",
              "--max-new-tokens-cap", "64"]
NEW_TOKENS = 32
# the serve-option, serve-tp and later serve runs: the first 16 tokens of
# each request (their streams held against the first 16 of the plain
# run's, where those are compared)
OPTION_NEW_TOKENS = 16
PROMPTS = tuple(
    ("The quick brown fox jumps over the lazy dog. " * 3)[:n]
    for n in (5, 12, 16, 23, 31, 40, 57, 64, 77, 96, 110, 120)
)
# the serve-option runs: speculative decoding (n-gram drafts, k = 4),
# chunked prefill (32 a chunk) and the prefix cache, over 12 prompts that
# share a 64-byte prefix (4 pages of 16) with distinct tails; two tails
# diverge from an earlier one mid-page (bytes 75 and 89), so their hits
# copy a page on write
SHARED_PREFIX = ("System prompt: you are a careful assistant; answer in one "
                 "line. ")
PREFIX_PROMPTS = tuple(SHARED_PREFIX + t for t in (
    "Summarize the report on river pollution.",
    "What is the capital of France?",
    "Summarize the report on rainfall in May.",
    "Summarize two books by the same author.",
    "Name three prime numbers.",
    "Translate good morning into Spanish.",
    "Who painted the ceiling of the Sistine Chapel?",
    "Give one synonym for quick.",
    "How many legs does a spider have?",
    "Explain what a compiler does.",
    "List the planets nearest the sun.",
    "What year did the first moon landing happen?",
))
INT8 = ["--weights-dtype", "int8", "--kv-dtype", "int8"]
# the serve-option and serve-tp runs: the first 8 of each prompt set (one
# wave of the 8 slots; the prefix set's two mid-page divergences, prompts
# 2 and 3 from prompt 0, included)
OPTION_PROMPTS = PROMPTS[:8]
OPTION_PREFIX_PROMPTS = PREFIX_PROMPTS[:8]
SERVE_OPTIONS = (
    ("spec", ["--spec-k", "4"], OPTION_PROMPTS),
    ("chunked", ["--prefill-chunk", "32"], OPTION_PROMPTS),
    ("prefix", ["--prefix-cache"], OPTION_PREFIX_PROMPTS),
    # int8 serving: weights and KV pools (kernels 12 and 13 on int8 pools),
    # plain, speculative and with the prefix cache (its COW copies carry
    # the scale pools); then weights only, on float pools
    ("int8", INT8, OPTION_PROMPTS),
    ("int8-spec", INT8 + ["--spec-k", "4"], OPTION_PROMPTS),
    ("int8-prefix", INT8 + ["--prefix-cache"], OPTION_PREFIX_PROMPTS),
    ("int8-weights", ["--weights-dtype", "int8"], OPTION_PROMPTS),
)
# two-pass LM run against the fused one: step 1's loss is the same
# forward, so bit-identical; later steps carry the gradients' other
# summation order (dq summed in registers, not as per-k-tile partials)
TWO_PASS_RTOL = 1e-3
# full-sequence check: a served greedy token's logit may trail the
# full-sequence maximum by this much (bf16 activations over 24 layers,
# other matmul shapes; logits of the random model have a spread of ~0.6)
MARGIN_TOL = 0.1
# the same under int8 KV pools, fixed before any run: each attended K/V
# entry carries up to half a step of its row's absmax / 127 (~0.4% of it)
# through 24 layers, where the float pools carry one bf16 rounding (0.4%)
INT8_KV_MARGIN_TOL = 0.25

# training-kernel shapes: the main path's rows 8 x 128 = 1024 at H 1024,
# ragged row counts, and the widths of the tiny and bert-base presets
TRAIN_SHAPES = ((1024, 1024), (8, 1024), (1000, 1024), (4096, 1024),
                (1024, 64), (1024, 768), (1000, 768), (8, 64))
MAIN_ROWS, MAIN_H = 1024, 1024
DROPOUT_RATE = 0.1        # hidden_dropout = attention_dropout of the presets
# the probs of bert-large at micro 8, seq 128; its embeddings; ragged sizes
MASK_SHAPES = ((8, 16, 128, 128), (8, 128, 1024), (1000, 3), (7,), (8, 1024))
# kernel 5's parity shapes: those and lm-1024's residual sites (4 x 1024 x
# 1024); apply timed at BERT's probs, lm-1024's residual sites, BERT's
# embeddings and its classifier
MASK_PARITY_SHAPES = MASK_SHAPES + ((4, 1024, 1024),)
APPLY_SHAPES = ((8, 16, 128, 128), (4, 1024, 1024), (8, 128, 1024),
                (8, 1024))
# float32 dscale/dbias sums over rows in another order: |got - want| <=
# 2^-16 of the column's sum of absolute terms
PARAM_SUM_SLACK = 2.0 ** -16
# kernel 2 at the training shapes and the widest row and one no multiple
# of 8 (single-element chunks)
LN_BWD_SHAPES = TRAIN_SHAPES + ((1024, 2048), (8, 2048), (1000, 1001),
                                (64, 1001))
# the eval forward's rows of kernel 3 (eval batch 32 x seq 128)
DAL_EVAL_ROWS = 4096
# the train phases' runs: the cold one on the C++ batch assembler, required
# (a batcher that does not build fails it), the rerun on the Python loader
# without prefetch
NATIVE_ON = ["--native-loader", "on"]
PYTHON_LOADER = ["--native-loader", "off", "--prefetch-depth", "0"]
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
# train_mp's main path: the reference MP script's bert-base-cased x 3
# branches (test_model_parallelism.py:230-238; train_mp's defaults, branch
# mode) on the reference recipe, 3 steps of 96 = 8 x 12, the full eval
TRAIN_MP_ARGS = ["--model", "bert-base-cased", "--task", "synthetic",
                 "--train-size", "288", "--eval-size", "408",
                 "--num-epochs", "1", "--device", "cuda", "--seed", "42",
                 "--log-every", "0"]
# the BERT profile phases run one step of the recipe's 96 and the full
# eval (three steps took 136-212 s under the profiler)
PROFILE_TRAIN_SIZE = "96"
# train-pipeline: train_mp's preset (bert-base-cased, JAX cli/train_mp.py:
# 44-46) at the recipe, through the schedules and stage mode at world size
# 1; two steps, since the first's learning rate is 0 (warmup), and a 96-row
# eval
PIPELINE_ARGS = ["--model", "bert-base-cased", "--task", "synthetic",
                 "--train-size", "192", "--eval-size", "96", "--num-epochs",
                 "1", "--device", "cuda", "--seed", "42", "--log-every", "0"]
PIPELINE_MODES = ("pipeline", "1f1b", "stage")
# cpu-vs-card through train_mp: 3 tiny branches on the whole-sequence
# flash kernels (7, 8; float32, head_dim 16)
TINY_MP_ARGS = TINY_ARGS + ["--n-branches", "3", "--attention", "flash"]

# flash attention at the LM paths' shapes: gpt2-medium at seq 1024, micro
# 4 (blockwise pair) and at seq 128, micro 8 (whole-sequence pair)
FLASH_BLOCKWISE = (4, 16, 1024, 64)
FLASH_WHOLE = (8, 16, 128, 64)
# the tensor-core path at head_dim 32 (its scale is not a power of two)
FLASH_BLOCKWISE_D32 = (4, 16, 1024, 32)
# kernels 7 and 8 alone, (shape, q scale): head_dim 32 and 16, three and
# four 64-key tiles (190, 256 keys, kernel 7's larger shared memory), a
# length off the 64-key tile (100) and off a multiple of 4 (190); the main
# shape with q x 16, whose scores spread past 62, so a warp's p fall below
# 2^-90 and its divisions take the IEEE route
FLASH_WHOLE_ALONE = (((8, 16, 128, 32), 1), ((4, 16, 256, 64), 1),
                     ((4, 4, 100, 16), 1), ((3, 4, 190, 64), 1),
                     (FLASH_WHOLE, 16))
# the tensor-core kernels' masks bit for bit: (Sq, Sk) with Sk a multiple
# of 4 (lanes share a Philox call) and not (each lane draws its own)
FLASH_MASK_SHAPES = ((64, 64), (48, 36), (64, 62))
# kernels 7 and 8's masks at Sq = Sk: one k-tile, a ragged one, two and
# four k-tiles
FLASH_WHOLE_MASK_LENGTHS = (64, 62, 128, 256)
# kernel 10's masks: the shapes above, and several k-tiles with Sk a
# multiple of 4 and not
FLASH_DQ_MASK_SHAPES = FLASH_MASK_SHAPES + ((130, 190), (128, 256))
# the FMA flash kernels take float32 only: a bf16 LM run's profile holds
# none of them
FMA_FLASH_SYMBOLS = ("flash_fwd_kernel<", "flash_bwd_kernel<",
                     "flash_dq_kernel<")
# kernel 13's FMA kernel takes float32 pools only: a serve-option run on
# bf16 or int8 pools holds none of it
FMA_PAGED_SYMBOLS = ("paged_mq_kernel<",)
# the serve-option runs profiled (spec: its second run); chunked and
# prefix run kernel 13 on bf16 pools as spec does, unprofiled to make room
PROFILED_OPTIONS = ("spec", "int8")
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
# lm-fsdp: lm-1024's shape cut to 2 steps, sharded by the placements of
# this fsdp size on a one-rank device mesh (one card is world size 1)
_AT = LM_1024_ARGS.index("--train-size") + 1
LM_FSDP_ARGS = (LM_1024_ARGS[:_AT] + ["64", "--eval-size", "16"]
                + LM_1024_ARGS[_AT + 3:])
LM_FSDP_SIZE = 2
# the lm-1024 profiles' rows: 1 step of 32
LM_PROFILE_TRAIN_SIZE = "32"
# scanned against unscanned: the grad norm sums the stacked squares in
# another order, so it and the weights after it agree to this
SCAN_RTOL = 1e-6
# gpt2-tiny keeps "reference" attention as its preset; --attention flash
# puts the whole-sequence kernels (head_dim 16, float32) on the path
TINY_LM_ARGS = ["--model", "gpt2-tiny", "--attention", "flash", "--task", "lm",
                "--train-size", "32",
                "--eval-size", "32", "--global-batch-size", "16",
                "--micro-batch-size", "8", "--num-epochs", "1", "--seed", "7",
                "--no-bf16", "--warmup-steps", "1", "--learning-rate", "1e-3",
                "--log-every", "0"]
# remat: lm-1024's shape (gpt2-medium, seq 1024, micro 4, flash), 2 steps
# of 16 = 4 x 4 and an 8-row eval, under each setting; then micro 8 (2
# steps of 32 = 8 x 4) without remat and with --remat-mlp
_GB = LM_1024_ARGS.index("--global-batch-size") + 1
REMAT_ARGS = (LM_1024_ARGS[:_GB] + ["16"] + LM_1024_ARGS[_GB + 1:_AT]
              + ["32", "--eval-size", "8"] + LM_1024_ARGS[_AT + 3:])
REMAT_SETTINGS = (
    ("none", []), ("remat", ["--remat"]),
    ("remat-dots", ["--remat", "--remat-policy", "dots"]),
    ("remat-weight-dots", ["--remat", "--remat-policy", "weight_dots"]),
    ("remat-mlp", ["--remat-mlp"]))

# int8-gemm: bert-large's six dense sites at the recipe's 1024 tokens a
# microbatch (8 x 128): (site, tokens, in features, out features)
INT8_GEMM_SITES = (("query", 1024, 1024, 1024), ("key", 1024, 1024, 1024),
                   ("value", 1024, 1024, 1024), ("out", 1024, 1024, 1024),
                   ("mlp_up", 1024, 1024, 4096),
                   ("mlp_down", 1024, 4096, 1024))
# ... and a product _int_mm cannot take as it is (5 rows, k and n off 8),
# which int8_mm pads with zero rows and columns
INT8_GEMM_PADDED = (("padded", 5, 60, 36),)
# NVIDIA H100 SXM data sheet: dense int8 tensor-core rate
INT8_OPS_PER_S = 1979e12
# train-int8: bert-large at the recipe's micro batch, 2 steps of 32 = 8 x 4
# (the first's learning rate is 0) and a 16-row eval, native and each int8
# variant
INT8_TRAIN_ARGS = ["--model", "bert-large-cased", "--task", "synthetic",
                   "--train-size", "64", "--global-batch-size", "32",
                   "--eval-size", "16",
                   "--num-epochs", "1", "--device", "cuda", "--seed", "42",
                   "--log-every", "0"]
# train-options: runs 2-4 on train-int8's shape (its native run is run 1)
OPTION_TRAIN_RUNS = (
    ("bf16-moments", ["--adam-mu-dtype", "bfloat16",
                      "--adam-nu-dtype", "bfloat16"]),
    ("bf16-carry", ["--grad-accum-dtype", "bfloat16"]),
    ("chain-2", ["--chain-steps", "2"]))
# kernels 1-5's symbols, as a trace names them
TRAIN_KERNEL_SYMBOLS = ("layer_norm_fwd_kernel", "layer_norm_bwd_dx_kernel",
                        "dal_fwd_kernel", "dal_bwd_dx_kernel",
                        "dropout_kernel")
INT8_VARIANTS = (
    ("int8", ["--matmul-impl", "int8"]),
    ("int8_full", ["--matmul-impl", "int8_full"]),
    ("int8_full-delayed", ["--matmul-impl", "int8_full", "--quant-delayed",
                           "--quant-delayed-grads"]))
# step 1 (the initial weights) of an int8 variant against native bf16: the
# int8 grid's error on random-init logits, whose CE sits near ln 2
INT8_LOSS_ATOL = 2e-2
# lm-1024 at int8_full: 1 step of 32 = 4 x 8 and the 64-row eval
LM_INT8_ARGS = (LM_1024_ARGS[:_AT] + [LM_PROFILE_TRAIN_SIZE]
                + LM_1024_ARGS[_AT + 1:] + ["--matmul-impl", "int8_full"])
# cpu-vs-card at int8_full with delayed scales on both passes: float32
# inputs a ulp apart can round to int8 one step apart
TINY_INT8_ARGS = TINY_ARGS + ["--matmul-impl", "int8_full", "--quant-delayed",
                              "--quant-delayed-grads"]
INT8_CPU_CARD_RTOL = 1e-3
# mp-cp: train_mp at (seq 2) as two gloo processes on the card against one
# process at seq 1 (reference attention), tiny, float32, dropout off;
# the gloo tests' tolerances
MP_CP_MODES = ("branch", "pipeline")
MP_CP_TRAIN = dict(num_epochs=1, train_size=32, eval_size=24,
                   global_batch_size=16, micro_batch_size=8,
                   eval_batch_size=8, warmup_steps=1, learning_rate=1e-3,
                   log_every=0, seed=7)
MP_CP_RTOL = 1e-5
# roberta-mnli: the repo's fourth recipe (BASELINE.json configs[3]; the JAX
# preset utils/config.py:295-299) at the reference recipe (96 = 8 x 12,
# seq 128, bf16, dropout 0.1, seed 42), 2 steps of 192 rows and 96 rows of
# each MNLI validation split (the synthetic 3-class fallback)
ROBERTA_ARGS = ["--model", "roberta-large", "--task", "mnli", "--train-size",
                "192", "--eval-size", "96", "--num-epochs", "1", "--device",
                "cuda", "--seed", "42", "--log-every", "0"]
# dropout-streams: roberta-large, 1 step of 32 = 8 x 4 and 16 rows a split,
# under each stream with the LayerNorm kernels, and the kernel stream with
# the reference LayerNorm (model_preset overrides)
STREAM_SETTINGS = (("bits32", "fused"), ("bits8", "fused"),
                   ("exact", "fused"), ("kernel", "reference"))
# the streams rerun for bit-equality: kernel 5's two modes of their own
STREAM_RERUN = ("bits8", "exact")
STREAM_TRAIN = dict(train_size=32, global_batch_size=32, eval_size=16,
                    num_epochs=1, seed=42, log_every=0)
# the crash drill: the tiny preset, a checkpoint a step
DRILL_ARGS = TINY_ARGS + ["--device", "cuda", "--checkpoint-every-steps",
                          "1"]

_PKG = "pytorch_distributed_training_tpu"
REPLACES = {
    "layer_norm": f"{_PKG}/ops/layer_norm.py:102",
    "layer_norm_bwd": f"{_PKG}/ops/layer_norm.py:131",
    "dropout_add_layer_norm": f"{_PKG}/ops/layer_norm.py:296",
    "dropout_add_layer_norm_bwd": f"{_PKG}/ops/layer_norm.py:345",
    "mask_scale": f"{_PKG}/ops/dropout.py:107",
    "mask_scale_apply": f"{_PKG}/ops/dropout.py:107",
    # modes of kernel 5's template: JAX's bits8 and exact streams
    # (raw_dropout, ops/dropout.py:241-262) are jax.random draws
    "dropout_bits8": f"{_PKG}/ops/dropout.py:107",
    "dropout_exact": f"{_PKG}/ops/dropout.py:107",
    "paged_attention": f"{_PKG}/ops/paged_attention.py:238",
    "paged_attention_mq": f"{_PKG}/ops/paged_attention.py:417",
    "paged_attention_int8": f"{_PKG}/ops/paged_attention.py:250",
    "paged_attention_mq_int8": f"{_PKG}/ops/paged_attention.py:430",
    "flash_fwd": f"{_PKG}/ops/flash_attention.py:103",
    "flash_bwd": f"{_PKG}/ops/flash_attention.py:360",
    "flash_whole_fwd": f"{_PKG}/ops/flash_attention.py:467",
    "flash_whole_bwd": f"{_PKG}/ops/flash_attention.py:505",
    "flash_dq": f"{_PKG}/ops/flash_attention.py:186",
    "flash_dkv": f"{_PKG}/ops/flash_attention.py:306",
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


@functools.cache
def sm_clock_mhz() -> float:
    """The card's top SM clock, ``nvidia-smi``'s clocks.max.sm."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.split()[0])


def int_instr_per_s() -> float:
    """32-bit integer instructions a second one pipe of the card issues:
    SMs x INT_RESULTS_PER_CLOCK_SM x the top SM clock."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT_RESULTS_PER_CLOCK_SM * sm_clock_mhz() * 1e6


def bound(n_bytes: float, flops: float,
          flops_per_s: float = FP32_FLOPS_PER_S,
          int_instr: float = 0.0) -> tuple[float, str]:
    """Least time for the work on the card, in ms, and what bounds it:
    ``flops`` at ``flops_per_s``, ``int_instr`` 32-bit integer instructions
    (the busier pipe's) at ``int_instr_per_s``."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / flops_per_s * 1e3
    if int_instr:
        by_ops = max(by_ops, int_instr / int_instr_per_s() * 1e3)
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def philox_int(kernel: str, n: float) -> float:
    """Integer instructions of the busier pipe for ``n`` elements of
    ``kernel``'s mask (PHILOX_INT_PER_ELEMENT, else this run's SASS)."""
    per = PHILOX_INT_PER_ELEMENT.get(kernel)
    if per is None:
        c = SASS_MEASURED[kernel]
        per = (c["fma_heavy"], c["alu"])
    return max(per) * n


def sass_functions(lib_path: str) -> dict:
    """``cuobjdump -sass`` of a built library: mangled function name ->
    its SASS text."""
    from pytorch_distributed_training_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    parts = re.split(r"^\s*Function\s*:\s*(\S+)\s*$", text, flags=re.M)
    return dict(zip(parts[1::2], parts[2::2]))


_SASS_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]\s+)?"
                        r"([A-Z][A-Z0-9_]*)([.A-Z0-9_]*)")


def sass_per_element(sass: str, elements: int, need=None) -> dict:
    """Instructions an element, by pipe, of the loop in ``sass`` (one
    function of ``cuobjdump -sass``) that draws the most Philox groups (a
    backward branch and the address it jumps to bound a loop; the whole
    function when it has none), over the ``elements`` an iteration takes;
    and the loop's opcodes. Each instruction counts once (IMAD.WIDE
    too)."""
    insns, branches = [], []
    for line in sass.splitlines():
        m = _SASS_INSN.search(line)
        if not m:
            continue
        addr, op = int(m.group(1), 16), m.group(2)
        insns.append((addr, op, m.group(2) + m.group(3)))
        tgt = re.search(r"BRA(?:\.\w+)*\s+0x([0-9a-f]+)", line)
        if op == "BRA" and tgt:
            branches.append((addr, int(tgt.group(1), 16)))
    loops = [(t, a) for a, t in branches if t < a]
    if not loops:
        loops = [(insns[0][0], insns[-1][0])] if insns else [(0, -1)]

    def body(lo, hi):
        return [i for i in insns if lo <= i[0] <= hi]

    def philox(b):
        return sum(full == "IMAD.WIDE.U32" for _, _, full in b)

    # the loop with the most Philox products (IMAD.WIDE.U32), the
    # innermost of equals; with ``need``, among the loops holding that
    # opcode (the vector path's 16-byte store, where a scalar loop's
    # address products would outnumber its Philox ones)
    cands = [body(lo, hi) for lo, hi in loops]
    if need is not None:
        cands = [b for b in cands if any(f == need for _, _, f in b)]
    best = max(cands, key=lambda b: (philox(b), -len(b)))
    ops: dict[str, int] = {}
    for _, _, full in best:
        ops[full] = ops.get(full, 0) + 1
    heavy = sum(op in SASS_FMA_HEAVY for _, op, _ in best)
    alu = sum(op in SASS_ALU for _, op, _ in best)
    return dict(fma_heavy=heavy / elements, alu=alu / elements,
                loop_instructions=len(best), elements=elements,
                opcodes=dict(sorted(ops.items(), key=lambda kv: -kv[1])))


def sass_counts(loops=SASS_LOOPS) -> dict:
    """sass_per_element of each entry of ``loops`` in the built
    libraries."""
    from pytorch_distributed_training_tpu_torch.ops import _build

    funcs = {}
    out = {}
    for key, (lib, pattern, elements, *need) in loops.items():
        if lib not in funcs:
            funcs[lib] = sass_functions(str(_build._lib_path(lib)))
        hits = [n for n in funcs[lib] if re.search(pattern, n)]
        if len(hits) != 1:
            raise AssertionError(f"SASS of {key}: {len(hits)} functions "
                                 f"match {pattern!r} in lib{lib}: {hits}")
        out[key] = dict(sass_per_element(funcs[lib][hits[0]], elements,
                                         *need), function=hits[0])
    return out


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
    say(f"[device] clocks.max.sm {sm_clock_mhz():.0f} MHz x "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs x "
        f"{INT_RESULTS_PER_CLOCK_SM} a clock: {int_instr_per_s():.4g} "
        f"integer instructions/s a pipe")
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
        # the instantiations that spill (ptxas reports each entry function,
        # then its spill bytes)
        spilling = [
            m.group(1) for m in re.finditer(
                r"entry function '(\S+)'(.*?)(?=entry function|\Z)", log,
                re.S)
            if any(int(n) for n in re.findall(r"(\d+) bytes spill",
                                              m.group(2)))]
        say(f"[build] {name}: {len(regs)} instantiations, registers "
            f"{min(regs, default=0)}..{max(regs, default=0)}, spill bytes "
            f"{sum(spills)}" + (f", spilling {spilling}" if spilling else ""))
        if (name in ("layer_norm", "dropout_add_layer_norm", "dropout")
                and sum(spills)):
            raise AssertionError(f"{name} spills: {spilling}")
    # the Philox mask's integer instructions an element, by pipe, beside
    # the counts the bounds take
    SASS_MEASURED.update(sass_counts())
    for key, c in SASS_MEASURED.items():
        takes = PHILOX_INT_PER_ELEMENT.get(key, "these")
        say(f"[build] SASS {key}: {c['fma_heavy']:.3f} FMA-heavy + "
            f"{c['alu']:.3f} ALU integer instructions an element ("
            f"{c['loop_instructions']} in the loop over {c['elements']} "
            f"elements; bounds take {takes}) " + json.dumps(c["opcodes"]))


# ---------------------------------------------------------------- phase 3


def _off16(t):
    """A contiguous copy of ``t`` one element past a 16-byte boundary (a
    view at an odd storage offset: the kernels' single-element chunks)."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 and out.is_contiguous()
    return out


def layer_norm_phase(device, rows=LN_ROWS, widths=LN_WIDTHS,
                     hidden=LN_HIDDEN, serve_rows=8) -> dict:
    import torch
    import torch.nn.functional as F

    from pytorch_distributed_training_tpu_torch.ops.layer_norm import (
        layer_norm,
        reference_layer_norm,
    )

    g = torch.Generator(device=device).manual_seed(0)
    dtypes = (torch.bfloat16, torch.float32)
    worst = 0.0
    for h in widths:
        scale = 1.0 + 0.1 * torch.randn(h, generator=g, device=device)
        bias = 0.1 * torch.randn(h, generator=g, device=device)
        for n in rows:
            for in_dtype in dtypes:
                x = (3.0 + 2.0 * torch.randn(n, h, generator=g,
                                             device=device)).to(in_dtype)
                cases = [(x, out) for out in dtypes]
                if n in (serve_rows // 2, 300):   # x off 16 bytes, both plans
                    cases.append((_off16(x), torch.bfloat16))
                for xc, out_dtype in cases:
                    run = functools.partial(layer_norm, xc, scale, bias,
                                            eps=1e-5, out_dtype=out_dtype)
                    got = run()
                    want = reference_layer_norm(xc, scale, bias, eps=1e-5,
                                                out_dtype=out_dtype)
                    what = (f"layer_norm rows={n} H={h} {in_dtype} -> "
                            f"{out_dtype}"
                            + (" (x off 16 bytes)" if xc is not x else ""))
                    worst = max(worst, check_ln_close(what, got, want))
                    same_bits(what, got, run())
    say(f"[kernels] layer_norm parity ok: rows {list(rows)} x H "
        f"{list(widths)} x {{bf16, f32}} in -> {{bf16, f32}} out, and x off "
        f"16 bytes; max abs err {worst} (<= 1 bf16 ulp + {LN_FP32_SLACK} "
        f"per element); two calls bit-identical")

    scale = 1.0 + 0.1 * torch.randn(hidden, generator=g, device=device)
    bias = 0.1 * torch.randn(hidden, generator=g, device=device)
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


def paged_inputs(device, lengths, *, windows, heads, head_dim, page_size,
                 q_len=None, dtype=None, seed=0):
    """Pools filled with noise (the null page 0 included), each sequence's
    pages in a random order, block-table tails on page 0, one sequence a
    length; q [B, H, D], or [B, q_len, H, D] with ``q_len``; bf16 unless
    ``dtype`` says otherwise."""
    import torch

    dtype = dtype or torch.bfloat16
    g = torch.Generator(device=device).manual_seed(seed)
    need = [-(-n // page_size) for n in lengths]
    num_pages = 1 + sum(need) + 3
    shape = (num_pages, page_size, heads, head_dim)
    k_pages = torch.randn(shape, generator=g, device=device).to(dtype)
    v_pages = torch.randn(shape, generator=g, device=device).to(dtype)
    order = (torch.randperm(num_pages - 1, generator=g, device=device)
             + 1).tolist()
    bt = torch.zeros(len(lengths), windows, dtype=torch.int32)
    for b, n in enumerate(need):
        bt[b, :n] = torch.tensor([order.pop() for _ in range(n)])
    rows = () if q_len is None else (q_len,)
    q = torch.randn(len(lengths), *rows, heads, head_dim, generator=g,
                    device=device).to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32)
    return q, k_pages, v_pages, bt.to(device), lens.to(device)


def paged_bound(lengths, *, heads, head_dim, page_size, q_len=1,
                int8=False):
    """Least time of paged attention over ``lengths`` with ``q_len`` query
    rows a sequence: each visible K and V row read once (bf16; with
    ``int8``, int8 values and a 4-byte scale a row), q (bf16) and o (bf16;
    float32 with ``int8``) once, the block table and lengths; 4 D
    operations per (head, row, visible token) at the bf16 rate."""
    tokens = sum(lengths)
    pairs = sum(n - (q_len - 1) + r for n in lengths for r in range(q_len))
    row = head_dim + 4 if int8 else head_dim * 2
    n_bytes = (tokens * heads * row * 2
               + len(lengths) * q_len * heads * head_dim * (2 + (4 if int8
                                                               else 2))
               + sum(-(-n // page_size) for n in lengths) * 4
               + len(lengths) * 4)
    return bound(n_bytes, 4.0 * pairs * heads * head_dim, BF16_FLOPS_PER_S)


def same_bits(what, a, b) -> None:
    """Two calls of a kernel on the same inputs: identical bits."""
    import torch

    if not torch.equal(a.contiguous().view(torch.uint8),
                       b.contiguous().view(torch.uint8)):
        raise AssertionError(f"{what}: two calls differ in their bits")


def paged_parity(device, lengths, geo, dtype) -> float:
    """Kernel 12 on float pools of ``dtype`` (q the same) against its plain
    version in float32: bf16 within PAGED_TOL, float32 within
    FLASH_FP32_TOL x max(1, max|want|); a second call gives the same bits.
    Returns the largest error."""
    import torch

    from pytorch_distributed_training_tpu_torch.ops.paged_attention import (
        _paged_reference,
        paged_attention,
    )

    scale = geo["head_dim"] ** -0.5
    windows = -(-max(lengths) // geo["page_size"])
    q, kp, vp, bt, lens = paged_inputs(device, lengths, windows=windows,
                                       dtype=dtype, **geo)
    got = paged_attention(q, kp, vp, bt, lens, scale=scale)
    want = _paged_reference(q.float(), kp.float(), vp.float(), bt, lens,
                            scale)
    what = (f"paged_attention {dtype} D={geo['head_dim']} lengths "
            f"{list(lengths)}")
    if got.dtype != dtype or got.shape != want.shape:
        raise AssertionError(f"{what} gave {got.dtype} {tuple(got.shape)}")
    if dtype == torch.float32:
        err = check_flash_close(what, got, want, tol=FLASH_FP32_TOL * max(
            1.0, float(want.abs().max())))
    else:
        torch.testing.assert_close(got.float(), want, atol=PAGED_TOL,
                                   rtol=PAGED_TOL)
        err = float((got.float() - want).abs().max())
    same_bits(what, got, paged_attention(q, kp, vp, bt, lens, scale=scale))
    return err


def paged_phase(device, lengths=PAGED_LENGTHS, serve=SERVE_CONTEXTS,
                serve_windows=SERVE_WINDOWS, geometry=None,
                head_dims=PAGED_HEAD_DIMS) -> dict:
    import torch
    import torch.nn.functional as F

    from pytorch_distributed_training_tpu_torch.ops.paged_attention import (
        _paged_reference,
        paged_attention,
    )

    geo = dict(PAGED, **(geometry or {}))
    scale = geo["head_dim"] ** -0.5
    windows = -(-max(lengths) // geo["page_size"])
    errs = {}
    for d in (geo["head_dim"], *head_dims):
        for dtype in (torch.bfloat16, torch.float32):
            errs[f"D={d} {str(dtype)[6:]}"] = paged_parity(
                device, lengths, dict(geo, head_dim=d), dtype)
    err = max(errs.values())
    say(f"[kernels] paged_attention parity ok: lengths {list(lengths)}, "
        f"permuted pages, null-page tails, two calls bit-identical; max abs "
        f"err " + json.dumps(errs) + f" (bf16 atol=rtol={PAGED_TOL}, "
        f"float32 <= {FLASH_FP32_TOL} x max(1, max|want|))")

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


def paged_mq_phase(device, q_lens=PAGED_MQ_QLENS, lengths=PAGED_MQ_LENGTHS,
                   geometry=None, head_dims=PAGED_HEAD_DIMS,
                   head_dim_q_lens=PAGED_MQ_HEAD_DIM_QLENS) -> dict:
    """Kernel 13 against its plain version, float32 and bf16, at each
    q_len over lengths on and off page boundaries (each row's horizon, a
    row fully masked on whole computed pages, null-page tails), also at
    ``head_dims`` (at ``head_dim_q_lens``), two calls bit-identical; then
    timed at the verify and chunk shapes of the serve-option runs."""
    import torch
    import torch.nn.functional as F

    from pytorch_distributed_training_tpu_torch.ops.paged_attention import (
        _paged_reference_mq,
        paged_attention,
    )

    geo = dict(PAGED, **(geometry or {}))
    scale = geo["head_dim"] ** -0.5
    errs = {}
    cases = [(geo["head_dim"], q) for q in q_lens] + [
        (d, q) for d in head_dims for q in head_dim_q_lens]
    for d, q_len in cases:
        lens_q = tuple(n for n in (q_len, q_len + 1, *lengths) if n >= q_len)
        windows = -(-max(lens_q) // geo["page_size"])
        g = dict(geo, head_dim=d)
        for dtype in (torch.float32, torch.bfloat16):
            q, kp, vp, bt, lens = paged_inputs(
                device, lens_q, q_len=q_len, windows=windows, dtype=dtype,
                seed=q_len, **g)
            run = functools.partial(paged_attention, q, kp, vp, bt, lens,
                                    scale=d ** -0.5)
            got = run()
            want = _paged_reference_mq(q.float(), kp.float(), vp.float(), bt,
                                       lens, d ** -0.5)
            what = (f"paged_attention_mq {dtype} D={d} q_len {q_len} "
                    f"lengths {lens_q}")
            if got.dtype != dtype or got.shape != q.shape:
                raise AssertionError(f"{what} gave {got.dtype} "
                                     f"{tuple(got.shape)}")
            if dtype == torch.float32:
                # float32 kernel, float32 accumulation: FLASH_FP32_TOL
                lim = FLASH_FP32_TOL * max(1.0, float(want.abs().max()))
                err = check_flash_close(what, got, want, tol=lim)
            else:
                torch.testing.assert_close(got.float(), want, atol=PAGED_TOL,
                                           rtol=PAGED_TOL)
                err = float((got.float() - want).abs().max())
            same_bits(what, got, run())
            key = f"D={d} {str(dtype)[6:]}"
            errs[key] = max(errs.get(key, 0.0), err)
    worst = max(v for k, v in errs.items() if k.endswith("bfloat16"))
    worst32 = max(v for k, v in errs.items() if k.endswith("float32"))
    say(f"[kernels] paged_attention_mq parity ok: q_len {list(q_lens)} x "
        f"lengths (q_len, q_len + 1, {list(lengths)}), permuted pages, "
        f"null-page tails, rows masked on whole pages; head_dim "
        f"{list(head_dims)} at q_len {list(head_dim_q_lens)}; two calls "
        f"bit-identical; bf16 max abs err {worst} (atol=rtol={PAGED_TOL}), "
        f"float32 max abs err {worst32} (<= {FLASH_FP32_TOL} x max(1, "
        f"max|want|)); by head_dim " + json.dumps(errs))

    def timed(label, lens_list, q_len, windows):
        q, kp, vp, bt, lens = paged_inputs(
            device, lens_list, q_len=q_len, windows=windows, seed=1, **geo)
        # the library yardstick: SDPA over K/V gathered beforehand, with
        # the boolean causal-horizon mask
        idx = bt.long()
        b, h, d = q.shape[0], q.shape[2], q.shape[3]
        kg = kp[idx].reshape(b, -1, h, d).transpose(1, 2).contiguous()
        vg = vp[idx].reshape(b, -1, h, d).transpose(1, 2).contiguous()
        limit = (lens[:, None] - (q_len - 1)
                 + torch.arange(q_len, device=device)[None])
        mask = (torch.arange(kg.shape[2], device=device)[None, None]
                < limit[:, :, None])[:, None]
        q4 = q.transpose(1, 2).contiguous()
        kernel = functools.partial(paged_attention, q, kp, vp, bt, lens,
                                   scale=scale)
        t = dict(
            ms=time_ms(kernel), eager_ms=eager_ms(kernel),
            plain_ms=time_ms(lambda: _paged_reference_mq(q, kp, vp, bt, lens,
                                                         scale)),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q4, kg, vg, attn_mask=mask, scale=scale)),
        )
        t["bound_ms"], t["bound_by"] = paged_bound(
            lens_list, q_len=q_len, **geo)
        say(f"[kernels] paged_attention_mq {label} q [{b}, {q_len}, {h}, "
            f"{d}] bf16 lengths {list(lens_list)} W={windows}: "
            + json.dumps(t))
        return t

    verify = timed("verify", tuple(c + VERIFY_Q for c in SERVE_CONTEXTS),
                   VERIFY_Q, VERIFY_WINDOWS)
    chunks = {n: timed("chunk", (n,), CHUNK_Q, SERVE_WINDOWS)
              for n in CHUNK_CONTEXTS}
    return dict(max_abs_err=max(worst, worst32), **verify, chunk=chunks)


def paged_int8_phase(device, lengths=PAGED_LENGTHS, q_lens=PAGED_MQ_QLENS,
                     mq_lengths=PAGED_MQ_LENGTHS, geometry=None,
                     head_dims=PAGED_HEAD_DIMS,
                     head_dim_q_lens=PAGED_MQ_HEAD_DIM_QLENS):
    """Kernels 12 and 13 on int8 pools (K/V quantized by the port's
    ``quantize_kv``) against their plain int8 versions on the card, with
    bf16 and float32 q, at the parity lengths of the float phases (both
    also at ``head_dims``, kernel 13 there at ``head_dim_q_lens``; two
    calls bit-identical); then timed at the
    serve and parity shapes (12) and the verify and chunk shapes (13),
    beside SDPA on the gathered K/V dequantized to bf16 beforehand (the
    dequantization not timed). Returns (kernel 12 int8, kernel 13 int8)."""
    import torch
    import torch.nn.functional as F

    from pytorch_distributed_training_tpu_torch.ops.paged_attention import (
        _paged_reference,
        _paged_reference_mq,
        paged_attention,
    )
    from pytorch_distributed_training_tpu_torch.ops.quant import quantize_kv

    geo = dict(PAGED, **(geometry or {}))
    scale = geo["head_dim"] ** -0.5

    def inputs(lens, q_len, windows, dtype, seed, g=geo):
        q, kp, vp, bt, ln = paged_inputs(
            device, lens, q_len=q_len, windows=windows, dtype=torch.float32,
            seed=seed, **g)
        (kq, ks), (vq, vs) = quantize_kv(kp), quantize_kv(vp)
        return q.to(dtype), kq, vq, ks, vs, bt, ln

    def check(what, q_len, lens, windows, seed, g=geo):
        worst = 0.0
        for dtype in (torch.bfloat16, torch.float32):
            q, kq, vq, ks, vs, bt, ln = inputs(lens, q_len, windows, dtype,
                                               seed, g)
            run = functools.partial(paged_attention, q, kq, vq, bt, ln,
                                    scale=g["head_dim"] ** -0.5,
                                    k_scales=ks, v_scales=vs)
            got = run()
            ref = _paged_reference if q_len is None else _paged_reference_mq
            want = ref(q, kq, vq, bt, ln, g["head_dim"] ** -0.5, ks, vs)
            if got.dtype != torch.float32 or got.shape != q.shape:
                raise AssertionError(f"{what} gave {got.dtype} "
                                     f"{tuple(got.shape)}")
            lim = PAGED_INT8_TOL * max(1.0, float(want.abs().max()))
            tag = f"{what} {dtype} D={g['head_dim']} lengths {list(lens)}"
            worst = max(worst, check_flash_close(tag, got, want, tol=lim))
            same_bits(tag, got, run())
        return worst

    err12 = max(
        check("paged_attention_int8", None, lengths,
              -(-max(lengths) // geo["page_size"]), 0, dict(geo, head_dim=d))
        for d in (geo["head_dim"], *head_dims))
    err13 = 0.0
    for d, q_len in ([(geo["head_dim"], q) for q in q_lens]
                     + [(d, q) for d in head_dims for q in head_dim_q_lens]):
        lens_q = tuple(n for n in (q_len, q_len + 1, *mq_lengths)
                       if n >= q_len)
        err13 = max(err13, check(
            f"paged_attention_mq_int8 q_len {q_len}", q_len, lens_q,
            -(-max(lens_q) // geo["page_size"]), q_len,
            dict(geo, head_dim=d)))
    say(f"[kernels] int8 pools parity ok: kernel 12 lengths {list(lengths)}, "
        f"head_dim {[geo['head_dim'], *head_dims]}, max abs err {err12}; "
        f"kernel 13 q_len {list(q_lens)} x lengths (q_len, q_len + 1, "
        f"{list(mq_lengths)}), head_dim {list(head_dims)} at q_len "
        f"{list(head_dim_q_lens)}, max abs err {err13}; two calls "
        f"bit-identical; bf16 and float32 q, float32 out (<= "
        f"{PAGED_INT8_TOL} x max(1, max|want|))")

    def timed(label, lens, q_len, windows):
        q, kq, vq, ks, vs, bt, ln = inputs(lens, q_len, windows,
                                           torch.bfloat16, 1)
        idx = bt.long()
        b, h, d = q.shape[0], q.shape[-2], q.shape[-1]

        def gathered(pages, sc):   # dequantized to bf16, [B, H, T, D]
            x = pages[idx].float() * sc[idx][..., None]
            return (x.reshape(b, -1, h, d).transpose(1, 2).contiguous()
                    .bfloat16())

        kg, vg = gathered(kq, ks), gathered(vq, vs)
        rows = 1 if q_len is None else q_len
        limit = (ln[:, None] - (rows - 1)
                 + torch.arange(rows, device=device)[None])
        mask = (torch.arange(kg.shape[2], device=device)[None, None]
                < limit[:, :, None])[:, None]
        q4 = (q[:, :, None] if q_len is None
              else q.transpose(1, 2).contiguous())
        ref = _paged_reference if q_len is None else _paged_reference_mq
        kernel = functools.partial(paged_attention, q, kq, vq, bt, ln,
                                   scale=scale, k_scales=ks, v_scales=vs)
        t = dict(
            ms=time_ms(kernel), eager_ms=eager_ms(kernel),
            plain_ms=time_ms(lambda: ref(q, kq, vq, bt, ln, scale, ks, vs)),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q4, kg, vg, attn_mask=mask, scale=scale)),
        )
        t["bound_ms"], t["bound_by"] = paged_bound(
            lens, q_len=rows, int8=True, **geo)
        say(f"[kernels] int8 pools {label} q [{b}, {rows}, {h}, {d}] bf16 "
            f"lengths {list(lens)} W={windows}: " + json.dumps(t))
        return t

    serve = timed("paged_attention_int8 serve", SERVE_CONTEXTS, None,
                  SERVE_WINDOWS)
    timed("paged_attention_int8 parity", lengths, None,
          -(-max(lengths) // geo["page_size"]))
    verify = timed("paged_attention_mq_int8 verify",
                   tuple(c + VERIFY_Q for c in SERVE_CONTEXTS), VERIFY_Q,
                   VERIFY_WINDOWS)
    chunks = {n: timed("paged_attention_mq_int8 chunk", (n,), CHUNK_Q,
                       SERVE_WINDOWS) for n in CHUNK_CONTEXTS}
    return (dict(max_abs_err=err12, **serve),
            dict(max_abs_err=err13, **verify, chunk=chunks))


# ---------------------------------------------------------------- phase 6


def request_lines(prompts, new_tokens, extra=()) -> str:
    """The JSONL requests ``r0``, ``r1``, ... of ``prompts`` (greedy), then
    the request dicts of ``extra`` as they are."""
    return "".join(
        json.dumps({"id": f"r{i}", "prompt": p,
                    "max_new_tokens": new_tokens}) + "\n"
        for i, p in enumerate(prompts)
    ) + "".join(json.dumps(m) + "\n" for m in extra)


def serve_once(argv, prompts, new_tokens, extra=()):
    """One run of the port's serve_lm over a JSONL stream (``extra``: more
    request lines, ``request_lines``); returns (events, stats, launch
    counts of this run, wall seconds)."""
    from pytorch_distributed_training_tpu_torch.cli import serve_lm
    from pytorch_distributed_training_tpu_torch.ops import _build

    text = request_lines(prompts, new_tokens, extra)
    out = io.StringIO()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    stats = serve_lm.main(argv, in_stream=io.StringIO(text), out_stream=out)
    wall = time.perf_counter() - t0
    counts = dict(_build.LAUNCH_COUNTS)
    events = [json.loads(line) for line in out.getvalue().splitlines()]
    check_serve_guards(" ".join(argv), stats)
    return events, stats, counts, wall


def check_serve_guards(what, stats) -> None:
    """A serve_lm run under its default strict guards: no recompile and no
    implicit transfer after each program's warm-up (a violation would
    have failed the loop), and a warmed engine's collective audit ok."""
    got = (stats["guard_mode"], stats["guard_recompiles"],
           stats["guard_implicit_transfers"])
    audit = stats["comm_audit"]
    if got != ("strict", 0, 0) or (audit is not None and not audit["ok"]):
        raise AssertionError(f"{what}: guards {got}, audit {audit}")


def streams(events, prompts, new_tokens, extra=()) -> dict:
    """Per-request token ids; raises unless every request (``r<i>`` of
    ``prompts`` and those of ``extra``) ended ``done`` with
    ``new_tokens`` tokens."""
    toks = {f"r{i}": [] for i in range(len(prompts))}
    toks.update({m["id"]: [] for m in extra})
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
                launches=counts, guards=[stats[k] for k in (
                    "guard_mode", "guard_recompiles",
                    "guard_implicit_transfers")])
    say("[serve] cold run: " + json.dumps(cold))

    events, stats, _, wall = serve_once(argv, prompts, new_tokens)
    if streams(events, prompts, new_tokens) != toks:
        raise AssertionError("greedy streams differ between two serve runs")
    warm = serve_metrics(events, stats, wall)
    say("[serve] warm run: " + json.dumps(warm))
    say("[serve] greedy streams identical across two runs")
    return dict(cold, warm=warm, streams=toks)


def with_warmup(stats) -> dict:
    """``stats`` with the warm-up's dispatches (``warmup_dispatches``, by
    program) added to the dispatch counts the launch formulas read."""
    w = stats["warmup_dispatches"]
    verify = w.get("serve_verify", 0)
    return dict(
        stats,
        prefill_dispatches=stats["prefill_dispatches"] + sum(
            n for k, n in w.items() if k.startswith("serve_prefill_b")),
        prefill_chunks=stats["prefill_chunks"] + w.get("serve_chunk", 0),
        decode_dispatches=(stats["decode_dispatches"] + verify
                           + w.get("serve_decode", 0)),
        spec_dispatches=stats["spec_dispatches"] + verify)


def serve_option_launches(stats, n_layers) -> dict:
    """Launches of a serve run from the engine's counts: the 4-D-query
    kernel once a layer per verify and chunk dispatch, the decode kernel
    once a layer per plain decode dispatch (their int8-pool entries, and
    no float one, on int8 pools), the LayerNorm 2 a layer + 1 per bucket
    prefill, chunk and decode-phase dispatch."""
    verify, chunks = stats["spec_dispatches"], stats["prefill_chunks"]
    plain = stats["decode_dispatches"] - verify
    sfx = "_int8" if stats["kv_dtype"] == "int8" else ""
    want = {"layer_norm": (2 * n_layers + 1) * (
        stats["prefill_dispatches"] + chunks + stats["decode_dispatches"])}
    if plain:
        want["paged_attention" + sfx] = n_layers * plain
    if verify + chunks:
        want["paged_attention_mq" + sfx] = n_layers * (verify + chunks)
    return want


def serve_options_phase(plain_streams, new_tokens=OPTION_NEW_TOKENS,
                        n_layers=24) -> dict:
    """``serve_lm`` with each serving option on gpt2-medium at full width,
    counted: every request's token count, the launch counts against the
    engine's dispatch counts, the pages left (those the prefix cache
    holds), peak memory, one more run of each of ``PROFILED_OPTIONS``
    under the profiler (no kernel of ``FMA_PAGED_SYMBOLS``; the same
    greedy streams as the first run), and how many streams equal the
    plain run's first ``new_tokens``."""
    import torch

    res = {}
    for name, flags, prompts in SERVE_OPTIONS:
        argv = SERVE_ARGS + flags
        torch.cuda.reset_peak_memory_stats()
        events, stats, counts, wall = serve_once(argv, prompts, new_tokens)
        peak = torch.cuda.max_memory_allocated()
        toks = streams(events, prompts, new_tokens)
        check_launches(f"{name} serve run", counts,
                       serve_option_launches(stats, n_layers))
        pc = stats["prefix_cache"]
        held = pc["prefix_cached_pages"] if pc else 0
        if stats["kv_pages_used"] != held or stats["page_exhausted"]:
            raise AssertionError(
                f"{name}: {stats['kv_pages_used']} pages in use after the "
                f"run, the prefix cache holds {held}; page_exhausted "
                f"{stats['page_exhausted']}")
        ttft = [e["ttft_s"] for e in events if e["event"] == "done"]
        m = dict(
            wall_s=wall, requests=len(prompts),
            decode_tokens=stats["decode_tokens"],
            decode_dispatches=stats["decode_dispatches"],
            decode_tok_per_s=stats["decode_tokens"] / stats["decode_s"],
            ttft_p50_s=statistics.median(ttft), ttft_max_s=max(ttft),
            prefill_s=stats["prefill_s"], decode_s=stats["decode_s"],
            prefill_dispatches=stats["prefill_dispatches"],
            chunk_dispatches=stats["prefill_chunks"],
            verify_dispatches=stats["spec_dispatches"],
            peak_mem_bytes=peak, weight_bytes=stats["weight_bytes"],
            kv_bytes_per_token=stats["kv_bytes_per_token"],
            variant=stats["variant"], kv_dtype=stats["kv_dtype"],
            launches=counts,
        )
        if name == "spec":
            m.update(accepted_per_verify=stats["spec_accepted"]
                     / stats["spec_dispatches"],
                     accept_rate=stats["spec_accept_rate"],
                     tokens_per_dispatch=stats["tokens_per_dispatch"])
        if name in PROFILED_OPTIONS:
            # the busy share over this run's engine seconds; the profiled
            # run is the second of the option, and its greedy streams
            # must equal the first's
            m["profile"] = profile_phase(
                dict(prefill_s=stats["prefill_s"], decode_s=stats["decode_s"]),
                argv, prompts, new_tokens, tag=f"profile-{name}",
                forbid=FMA_PAGED_SYMBOLS)
            if m["profile"].pop("streams") != toks:
                raise AssertionError(f"{name}: greedy streams differ "
                                     f"between two runs")
        if pc:
            m.update(hit_rate=pc["prefix_hit_rate"],
                     prefix_hits=pc["prefix_hits"],
                     prefill_tokens_skipped=pc["prefill_tokens_skipped"],
                     prefill_tokens=stats["prefill_tokens"],
                     cow_copies=pc["cow_copies"],
                     cached_pages=pc["prefix_cached_pages"])
            if pc["cow_copies"] < 2 or pc["prefix_hits"] < len(prompts) - 1:
                raise AssertionError(f"prefix run: {pc}")
        if prompts is OPTION_PROMPTS:
            m["streams_equal_plain"] = sum(
                toks[r] == plain_streams[r][:new_tokens] for r in toks)
        say(f"[serve-{name}] " + json.dumps(m))
        res[name] = dict(m, streams=toks, prompts=prompts)
    say("[serve-spec] [serve-int8] greedy streams identical across two "
        "runs (the second profiled)")
    return res


def sampled_margin_check(model, name, toks, prompt, req, tol,
                         device) -> dict:
    """The greedy margin gate for a sampled stream (``req``: its
    temperature, top_k and seed): each token against the full-sequence
    forward of ``model`` on its context, divided by the temperature, cut
    to the top k and perturbed by the request's own Gumbel noise at that
    step (``serve/sampling.gumbel_noise``): its perturbed score must trail
    the maximum by at most ``tol`` / temperature."""
    import torch

    from pytorch_distributed_training_tpu_torch.data.bpe import ByteTokenizer
    from pytorch_distributed_training_tpu_torch.serve.sampling import (
        gumbel_noise,
    )

    temp, top_k = req["temperature"], req["top_k"]
    ids = ByteTokenizer().text_ids(prompt) + toks[:-1]
    with torch.inference_mode():
        rows = model(torch.tensor([ids], device=device))[0].float()
    rows = rows[len(ids) - len(toks):] / torch.tensor(temp, device=device)
    kth = torch.topk(rows, top_k, dim=1).values[:, -1:]
    rows = torch.where(rows < kth, torch.finfo(torch.float32).min, rows)
    noise = torch.stack([gumbel_noise(req["seed"], step, rows.shape[1])
                         for step in range(len(toks))]).to(device)
    rows = rows + noise
    picked = rows.gather(1, torch.tensor(toks, device=device)[:, None])[:, 0]
    margin = rows.max(dim=1).values - picked
    worst = float(margin.max())
    if worst > tol / temp:
        raise AssertionError(f"{name}: a sampled token trails the perturbed "
                             f"maximum by {worst} (> {tol} / {temp})")
    out = dict(tokens=len(toks), argmax_agree=int((margin == 0).sum()),
               worst_margin=worst, tolerance=tol / temp)
    say(f"[check] {name}: sampled tokens vs the full-sequence forward: "
        + json.dumps(out))
    return out


# the serve-dense-host phase's fixed-seed sampled request
SAMPLED_REQUEST = dict(id="s0", prompt=PROMPTS[6], max_new_tokens=16,
                       temperature=0.8, top_k=40, seed=7)


def serve_dense_host_phase(plain_streams, prompts=PROMPTS,
                           new_tokens=OPTION_NEW_TOKENS, n_layers=24,
                           argv=SERVE_ARGS, sample=SAMPLED_REQUEST) -> dict:
    """``serve_lm --kv-layout dense --sampling host`` (the dense per-slot
    cache, float32 logits sampled on the host) on the serve phase's
    prompts and one fixed-seed sampled request, counted (kernel 1 only: the
    dense cache attends by ``einsum``), the page counts None; then the
    sampled request alone through ``--kv-layout dense`` (device sampling)
    and through the paged layout and device sampling: the three streams
    equal (the host and the device sampler pick alike on the same logits;
    the two layouts' bf16 logits could part only at a near tie, which the
    sampled margin gate each stream passes would show). Returns the greedy
    streams (margin-gated in main) and the checks."""
    events, stats, counts, wall = serve_once(
        argv + ["--kv-layout", "dense", "--sampling", "host"], prompts,
        new_tokens, [sample])
    toks = streams(events, prompts, new_tokens, [sample])
    prefills, ticks = stats["admitted"], stats["decode_dispatches"]
    check_launches(f"serve-dense-host run ({prefills} prefills, {ticks} "
                   f"ticks)", counts,
                   {"layer_norm": (2 * n_layers + 1) * (prefills + ticks)})
    if (stats["kv_layout"], stats["sampling"], stats["kv_pages_total"]) != (
            "dense", "host", None):
        raise AssertionError(f"serve-dense-host: stats {stats}")
    sampled = {"dense-host": toks.pop("s0")}
    for name, flags in (("dense-device", ["--kv-layout", "dense"]),
                        ("paged-device", [])):
        ev, _, _, _ = serve_once(argv + flags, (), None, [sample])
        sampled[name] = streams(ev, (), sample["max_new_tokens"],
                                [sample])["s0"]
    if not (sampled["dense-host"] == sampled["dense-device"]
            == sampled["paged-device"]):
        raise AssertionError(f"serve-dense-host: the sampled streams "
                             f"differ: {sampled}")
    m = dict(serve_metrics(events, stats, wall), launches=counts,
             requests=len(prompts) + 1,
             streams_equal_plain=sum(toks[r] == plain_streams[r][:new_tokens]
                                     for r in toks),
             sampled=sampled)
    say("[serve-dense-host] " + json.dumps(m))
    return dict(m, streams=toks)


# serve-tenant: two tenants behind the prefix cache at a quarter of the
# pool each: "flood" sends long prompts on the shared prefix in the batch
# lane, "light" short ones in the interactive lane, all queued at once
TENANT_ARGS = SERVE_ARGS + ["--prefix-cache", "--tenant-page-quota", "0.25",
                            "--queue-depth", "64"]
TENANT_FLOOD = tuple(p[:110] for p in PREFIX_PROMPTS + PREFIX_PROMPTS[:4])
TENANT_LIGHT = tuple(p[:n] for p, n in zip(
    PROMPTS * 2, (5, 9, 12, 16, 20, 23, 27, 31) * 2))


def serve_tenant_phase(new_tokens=OPTION_NEW_TOKENS, n_layers=24,
                       argv=TENANT_ARGS, flood=TENANT_FLOOD,
                       light=TENANT_LIGHT) -> dict:
    """Tenant page quotas and the tier lanes through ``serve_lm``'s server
    (``build_server``; requests submitted with ``tier`` and ``tenant``):
    every request done with ``new_tokens`` tokens, no page exhaustion, the
    quota holding the flood (``tenant_blocked`` > 0), the launches
    against the engine's dispatch counts; the admission order read from
    the queue: the first lane cycle 4 interactive then 1 batch, and of the
    admissions while both lanes waited at least 4/5 interactive (the
    weights 4:1; a held batch turn goes to the other lane). Returns the
    greedy streams for the margin gate."""
    from pytorch_distributed_training_tpu_torch.cli import serve_lm
    from pytorch_distributed_training_tpu_torch.ops import _build

    args = serve_lm.build_parser().parse_args(argv)
    server, tok = serve_lm.build_server(args)
    queue, pops = server.queue, []
    pop_ready = queue.pop_ready

    def recorded(*a, **k):
        depth = queue.depth_by_tier()
        req = pop_ready(*a, **k)
        if req is not None:
            pops.append((req.tier, req.tenant, min(depth.values()) > 0))
        return req

    queue.pop_ready = recorded
    prompts = flood + light
    reqs = []
    for i, p in enumerate(prompts):
        in_flood = i < len(flood)
        reqs.append(server.submit(
            tok.text_ids(p), max_new_tokens=new_tokens, request_id=f"r{i}",
            tier="batch" if in_flood else "interactive",
            tenant="flood" if in_flood else "light"))
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    server.start()
    server.close(drain=True, timeout=600)
    wall = time.perf_counter() - t0
    counts = dict(_build.LAUNCH_COUNTS)
    stats = server.stats()
    bad = [(r.id, r.status, len(r.tokens)) for r in reqs
           if r.status != "done" or len(r.tokens) != new_tokens]
    pc = stats["prefix_cache"]
    if bad or stats["page_exhausted"] or not pc["tenant_blocked"]:
        raise AssertionError(f"serve-tenant: unfinished {bad}, "
                             f"page_exhausted {stats['page_exhausted']}, "
                             f"tenant_blocked {pc['tenant_blocked']}")
    check_launches("serve-tenant run", counts,
                   serve_option_launches(stats, n_layers))
    contended = [tier for tier, _, both in pops if both]
    share = contended.count("interactive") / len(contended)
    if [t for t, _, _ in pops[:5]] != ["interactive"] * 4 + ["batch"] or (
            share < 0.8):
        raise AssertionError(f"serve-tenant: admissions {pops}")
    m = dict(wall_s=wall, requests=len(reqs), flood=len(flood),
             light=len(light), admissions=len(pops),
             contended_admissions=len(contended),
             contended_interactive_share=share,
             first_cycle=[t for t, _, _ in pops[:5]],
             tenant_blocked=pc["tenant_blocked"],
             tenant_page_quota=pc["tenant_page_quota"],
             page_exhausted=stats["page_exhausted"],
             prefix_hits=pc["prefix_hits"], cow_copies=pc["cow_copies"],
             kv_pages_total=stats["kv_pages_total"],
             kv_pages_peak=stats["kv_pages_peak"],
             decode_dispatches=stats["decode_dispatches"],
             decode_tok_per_s=stats["decode_tokens"] / stats["decode_s"],
             ttft_p50_s={t: statistics.median(
                 r.first_token_t - r.submit_t for r in reqs if r.tier == t)
                 for t in ("interactive", "batch")},
             launches=counts)
    say("[serve-tenant] " + json.dumps(m))
    return dict(m, streams={r.id: [int(t) for t in r.tokens] for r in reqs},
                prompts=prompts)


def tick_phase(reps=20) -> dict:
    """One 8-slot decode dispatch of the serve engine (``_decode``: the
    model's paged decode step, sampling, the ids' copy to the host) over
    the serve contexts, with float and with int8 weights and pools: the
    kernels of one dispatch (``torch.profiler`` over that dispatch alone)
    and its host ms, the two engines alternated in one call (float, int8,
    int8, float; ``reps`` dispatches each time). Then on the float engine
    (serve_lm's default strict guards) the forced violations
    (``forced_violations``) and the guards' cost: the same dispatch, each
    inside the tick's ``transfer_scope``, with the guards ``off`` and in
    ``record`` mode, alternated in one call (off, record, record, off)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pytorch_distributed_training_tpu_torch.cli import serve_lm

    engines = {}
    for name, flags in (("float", []), ("int8", INT8)):
        server, _ = serve_lm.build_server(
            serve_lm.build_parser().parse_args(SERVE_ARGS + flags))
        engines[name] = server.engine
    cfg = engines["float"].config
    slots, width = cfg.num_slots, cfg.pages_per_slot
    ctx = np.asarray(SERVE_CONTEXTS[:slots], np.int32)
    args = (np.ones(slots, np.int64),
            (1 + np.arange(slots * width, dtype=np.int32)).reshape(
                slots, width),
            ctx, np.zeros(slots, np.int64), ctx.astype(np.int64),
            np.zeros(slots, np.float32), np.zeros(slots, np.int64))

    def kernels(engine):
        with torch.inference_mode():
            engine._decode(*args)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                engine._decode(*args)
        return sum(e.count for e in profile_averages(prof)
                   if e.device_type == DeviceType.CUDA
                   and _kernel_class(e.key) != "copy")

    def tick_ms(engine):
        with torch.inference_mode():
            t0 = time.perf_counter()
            for _ in range(reps):
                engine._decode(*args)     # ends in a copy to the host
        return 1e3 * (time.perf_counter() - t0) / reps

    res = {f"kernels_{k}": kernels(e) for k, e in engines.items()}
    res["kernels_added_by_int8"] = res["kernels_int8"] - res["kernels_float"]
    for k in ("float", "int8", "int8", "float"):
        res.setdefault(f"tick_ms_{k}", []).append(tick_ms(engines[k]))
    engine = engines["float"]
    res["forced"] = forced_violations(engine)
    guards = engine._guards

    def guarded_ms(mode):
        guards.mode = mode
        with torch.inference_mode():
            t0 = time.perf_counter()
            for _ in range(reps):
                with guards.transfer_scope("serve_tick"):
                    engine._decode(*args)
        return 1e3 * (time.perf_counter() - t0) / reps

    before = guards.violations
    for mode in ("off", "record", "record", "off"):
        res.setdefault(f"guards_ms_{mode}", []).append(guarded_ms(mode))
    guards.mode = "strict"
    if guards.violations != before:
        raise AssertionError(f"serve-tick: {guards.violations - before} "
                             f"violations in the record turns")
    say("[serve-tick] " + json.dumps(res))
    return res


def forced_violations(engine) -> dict:
    """On a warm engine under strict guards: a decode dispatch at a shape
    its warm-up did not see raises ``RecompileError`` (before it runs); a
    synchronizing call inside an armed ``transfer_scope`` raises
    ``TransferGuardError``; the same call on another thread while the
    scope is armed neither raises nor counts."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from pytorch_distributed_training_tpu_torch.analysis.guards import (
        RecompileError,
        TransferGuardError,
    )

    guards, res = engine._guards, {}
    if guards.mode != "strict" or not engine._programs["serve_decode"].warm:
        raise AssertionError(f"forced: guards {guards.mode}, decode warm "
                             f"{engine._programs['serve_decode'].warm}")
    slots, width = engine.config.num_slots, engine.config.pages_per_slot
    n0 = (guards.recompile_violations, guards.transfer_violations)
    with torch.inference_mode():
        try:
            engine._forward(np.ones((slots + 1, 1), np.int64),
                            np.ones((slots + 1, 1), np.int64),
                            np.zeros((slots + 1, width), np.int32),
                            np.zeros(slots + 1, np.int32),
                            program="serve_decode")
        except RecompileError as e:
            res["recompile"] = str(e).split(" — ")[0]
        x = torch.ones(4, device="cuda")
        try:
            with guards.transfer_scope("forced"):
                x.sum().item()
        except TransferGuardError as e:
            res["transfer"] = str(e).splitlines()[0][:120]
        n1 = (guards.recompile_violations, guards.transfer_violations)
        other = []

        def on_another_thread():
            try:
                other.append(x.sum().item())
            except Exception as e:  # noqa: BLE001 - reported below
                other.append(repr(e))

        with guards.transfer_scope("forced"), ThreadPoolExecutor(1) as pool:
            pool.submit(on_another_thread).result(timeout=60)
    res["other_thread"] = other
    if ("recompile" not in res or "transfer" not in res
            or n1 != (n0[0] + 1, n0[1] + 1) or other != [4.0]
            or (guards.recompile_violations,
                guards.transfer_violations) != n1):
        raise AssertionError(f"forced violations: {res}, counts {n0} -> "
                             f"{n1}")
    say("[serve-tick] forced violations raise on the armed thread only: "
        + json.dumps(res))
    return res


_PORT_KERNELS = (
    ("layer_norm_fwd_kernel", "layer_norm"),
    ("layer_norm_bwd_dx_kernel", "layer_norm_bwd dx pass"),
    ("layer_norm_bwd_params_kernel", "layer_norm_bwd column pass"),
    ("dal_fwd_kernel", "dropout_add_layer_norm"),
    ("dal_bwd_dx_kernel", "dropout_add_layer_norm_bwd dx pass"),
    ("dal_bwd_params_kernel", "dropout_add_layer_norm_bwd column pass"),
    # csrc/dropout.cu's template <T, Idx, CPT, APPLY>
    (r"dropout_kernel<[^>]*true>", "mask_scale_apply"),
    ("dropout_kernel<", "mask_scale"),
    ("paged_decode_kernel", "paged_attention"),
    ("paged_mq_mma_kernel<", "paged_attention_mq"),
    ("paged_mq_kernel<", "paged_attention_mq (float32)"),
    ("flash_fwd_mma_kernel<", "flash_fwd"),
    ("flash_whole_fwd_mma_kernel<", "flash_whole_fwd"),
    ("flash_whole_stats_mma_kernel<", "flash_whole_bwd statistics pre-pass"),
    ("flash_dq_mma_kernel<", "flash_dq"),
    # the tensor-core backward template <D, kDq, kWhole>: kernel 9
    # <D, true, false>, kernel 11 <D, false, false>, kernel 8
    # <D, true, true>
    (r"flash_bwd_mma_kernel<\d+, false, false>", "flash_dkv"),
    (r"flash_bwd_mma_kernel<\d+, true, true>", "flash_whole_bwd"),
    ("flash_bwd_mma_kernel<", "flash_bwd"),
    ("flash_delta_kernel<", "flash_bwd / flash_dq + flash_dkv delta pre-pass"),
    ("flash_fwd_kernel<", "flash_fwd / flash_whole_fwd (float32)"),
    ("flash_bwd_kernel<",
     "flash_bwd / flash_dkv / flash_whole_bwd (float32)"),
    ("flash_dq_sum_kernel", "flash_bwd / flash_whole_bwd dq sum"),
    ("flash_dq_kernel<", "flash_dq (float32)"),
)


def _kernel_class(name: str) -> str:
    for symbol, kernel in _PORT_KERNELS:
        if re.search(symbol, name):
            if symbol.startswith("paged") and "signed char" in name:
                kernel += "_int8"   # the int8-pool instantiation
            return f"{kernel} (port kernel)"
    low = name.lower()
    if "nccl" in low:
        return "collective (nccl)"
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
                  new_tokens=NEW_TOKENS, tag="profile", forbid=()) -> dict:
    """Device kernel time of one more serve run under ``torch.profiler``,
    by kernel class, kernel 13's share of it, and the device's busy share
    of the warm run's engine seconds (prefill + decode dispatches, each
    ending in a host copy). The server is built first (weights copied to
    the card) and the profiler covers only the requests; a device kernel
    whose name holds a ``forbid`` symbol fails the phase."""
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
    toks = streams(events, prompts, new_tokens)
    # aggregated once: each call walks every event again (seconds)
    averages = profile_averages(prof)
    bad = sorted({e.key[:90] for e in averages
                  if e.device_type == DeviceType.CUDA
                  and any(sym in e.key for sym in forbid)})
    if bad:
        raise AssertionError(f"{tag}: launched {bad}, none wanted")
    engine_s = warm["prefill_s"] + warm["decode_s"]
    res = device_time_by_class(averages, engine_s)
    mq = sum(v for k, v in res["by_class_ms"].items()
             if k.startswith("paged_attention_mq"))
    res.update(paged_mq_ms=mq, paged_mq_share=(
        mq / res["device_kernel_ms"] if res["device_kernel_ms"] else None))
    say(f"[{tag}] " + json.dumps(res))
    return dict(res, streams=toks)


class _Event:
    """One event of a profile, as torch's ``FunctionEvent`` sees it."""

    __slots__ = ("name", "device_type", "start", "end", "thread", "is_async",
                 "is_user_annotation", "is_legacy", "kernels", "children",
                 "parent")

    def __init__(self, name, device_type, start, end, thread, is_async,
                 is_user_annotation):
        self.name, self.device_type = name, device_type
        self.start, self.end, self.thread = start, end, thread
        self.is_async, self.is_user_annotation = is_async, is_user_annotation
        self.is_legacy = False
        self.kernels, self.children, self.parent = [], [], None


class _Average:
    """``FunctionEventAvg``'s fields the profile phases read."""

    __slots__ = ("key", "device_type", "is_user_annotation", "count",
                 "self_cpu_time_total", "device_time_total",
                 "self_device_time_total")

    def __init__(self, key, device_type, is_user_annotation):
        self.key, self.device_type = key, device_type
        self.is_user_annotation = is_user_annotation
        self.count = 0
        self.self_cpu_time_total = self.device_time_total = 0.0
        self.self_device_time_total = 0.0


def profile_averages(prof) -> list:
    """``profile_averages(prof)`` (its counts, host self times, device times
    and device self times, grouped as it groups them) computed from the
    profiler's raw events with torch's own rules (``autograd/profiler.py``
    ``_parse_kineto_results``, ``profiler_util.py`` ``EventList.
    _build_tree``): the names filtered and demangled, device kernels and
    runtime calls linked to the op that launched them, the CPU events
    nested by thread, a parent's only child of its own name folded into
    it. torch builds a Python object a raw event on the way, which takes
    tens of seconds for a training step's trace; this takes a second."""
    gc.disable()  # the events' parent links are cycles: no scans midway
    try:
        return _profile_averages(prof)
    finally:
        gc.enable()


def _profile_averages(prof) -> list:
    import itertools

    import torch
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _filter_name

    result = prof.profiler.kineto_results
    use_device = prof.profiler.use_device
    origin = result.trace_start_ns()
    names: dict = {}
    events, frontend, linked = [], [], {}
    for raw in result.events():
        name = raw.name()
        if _filter_name(name) or raw.is_hidden_event():
            continue
        if name not in names:
            shown = torch._C._demangle(name) if len(name) > 1 else name
            names[name] = ("ProfilerStep*" if shown.startswith(
                "ProfilerStep#") else shown)
        dev = raw.device_type()
        e = _Event(names[name], dev, (raw.start_ns() - origin) / 1000,
                   (raw.end_ns() - origin) / 1000, raw.start_thread_id(),
                   raw.is_async() or (raw.start_thread_id()
                                      != raw.end_thread_id()),
                   raw.is_user_annotation())
        if dev == DeviceType.CPU and not e.is_async and use_device == "cuda":
            legacy_us = raw.cuda_elapsed_us()
            if legacy_us > 0:
                e.kernels.append(legacy_us)
                e.is_legacy = True
        events.append(e)
        corr = raw.linked_correlation_id()
        if corr > 0:
            linked.setdefault(corr, []).append(e)
        elif corr == 0:
            frontend.append((raw.correlation_id(), e))
    for corr, e in frontend:
        if e.device_type != DeviceType.CPU or e.is_async:
            continue
        for f in linked.get(corr, ()):
            if f.device_type == DeviceType.CUDA:
                e.kernels.append(f.end - f.start)
            elif f.device_type == DeviceType.CPU:
                f.thread = e.thread
    sync = sorted((e for e in events
                   if not e.is_async and e.device_type == DeviceType.CPU),
                  key=lambda e: e.thread)
    for _, run in itertools.groupby(sync, key=lambda e: e.thread):
        stack: list = []
        for e in sorted(run, key=lambda e: (e.start, -e.end)):
            while stack:
                top = stack[-1]
                if e.start >= top.end or e.end > top.end:
                    stack.pop()
                else:
                    top.children.append(e)
                    e.parent = top
                    break
            stack.append(e)
    while True:
        folded = set()
        for e in events:
            p = e.parent
            if p is not None and p.name == e.name and len(p.children) == 1:
                p.children, p.kernels = e.children, e.kernels
                for c in e.children:
                    c.parent = p
                folded.add(id(e))
        if not folded:
            break
        events = [e for e in events if id(e) not in folded]

    device_total: dict = {}

    def device_time(e) -> float:
        if e.is_async or not use_device:
            return 0.0
        if e.device_type != DeviceType.CPU:
            return e.end - e.start
        if id(e) not in device_total:
            total = sum(e.kernels)
            if not e.is_legacy:
                # children first, deepest last: no recursion limit
                pending = [c for c in e.children if id(c) not in device_total]
                while pending:
                    c = pending[-1]
                    todo = [g for g in c.children if id(g) not in device_total]
                    if todo:
                        pending += todo
                        continue
                    pending.pop()
                    device_time(c)
                total += sum(device_total[id(c)] for c in e.children)
            device_total[id(e)] = total
        return device_total[id(e)]

    out: dict = {}
    for e in events:
        key = (e.name, e.device_type, e.is_legacy, e.is_user_annotation)
        avg = out.get(key)
        if avg is None:
            avg = out[key] = _Average(e.name, e.device_type,
                                      e.is_user_annotation)
        avg.count += 1
        dt = device_time(e)
        avg.device_time_total += dt
        if e.is_async:
            continue
        if e.device_type == DeviceType.CPU:
            avg.self_cpu_time_total += (e.end - e.start) - sum(
                c.end - c.start for c in e.children)
            avg.self_device_time_total += dt - sum(
                device_time(c) for c in e.children)
        elif use_device:
            avg.self_device_time_total += dt
    return list(out.values())


def device_time_by_class(averages, wall_s, top_n=10) -> dict:
    """Device kernel time of a ``torch.profiler`` run (its
    ``profile_averages``) by kernel class, and its share of ``wall_s`` (the
    host seconds of the profiled work)."""
    from torch.autograd import DeviceType

    by_class: dict[str, float] = {}
    launches: dict[str, int] = {}
    top = []
    for e in averages:
        # a user range on the device (the optimizer's "Optimizer.step#..."
        # annotation) spans kernels counted on their own: skip it
        if (e.device_type != DeviceType.CUDA or "#" in e.key
                or getattr(e, "is_user_annotation", False)):
            continue
        us = float(getattr(e, "self_device_time_total", 0.0))
        cls = _kernel_class(e.key)
        by_class[cls] = by_class.get(cls, 0.0) + us
        launches[cls] = launches.get(cls, 0) + e.count
        top.append((us, e.count, e.key[:90]))
    total_us = sum(by_class.values())
    for us, count, name in sorted(top, reverse=True)[:top_n]:
        say(f"[profile] {us / 1e3:9.3f} ms {count:6d}x {name}")
    # each port kernel's device us a launch (class time / launches), and a
    # two-pass backward's us a call (both passes over the dx pass's
    # launches; each call launches both, so their counts must agree)
    per_launch = {k: by_class[k] / launches[k] for k in by_class
                  if k.endswith("(port kernel)") and launches[k]}
    dx_tail = " dx pass (port kernel)"
    for dx in [k for k in by_class if k.endswith(dx_tail)]:
        kernel = dx[:-len(dx_tail)]
        col = f"{kernel} column pass (port kernel)"
        if launches.get(col, 0) != launches[dx]:
            raise AssertionError(f"{kernel}: {launches[dx]} dx passes but "
                                 f"{launches.get(col, 0)} column passes")
        per_launch[f"{kernel} (port kernel, dx + column pass)"] = (
            (by_class[dx] + by_class[col]) / launches[dx])
    return dict(
        device_kernel_ms=total_us / 1e3,
        busy_share=total_us / 1e6 / wall_s if wall_s else None,
        by_class_ms={k: v / 1e3 for k, v in sorted(
            by_class.items(), key=lambda kv: -kv[1])},
        port_us_per_launch=per_launch,
        port_launches={k: n for k, n in launches.items()
                       if k.endswith("(port kernel)")},
    )


def full_sequence_phase(device, runs, model_name="gpt2-medium",
                        seed=0, sampled=()) -> dict:
    """Each served greedy token against a full-sequence forward (plain
    attention, no pages) of the same model on the served context; ``runs``
    maps a run's name to its (streams, prompts, weights dtype, margin
    tolerance): the model's float32 weights cast for serving as the run's
    engine casts them (int8: the same quantized projections, dequantized
    per call). ``sampled``: (name, tokens, prompt, request) of sampled
    streams on the float32 weights, through ``sampled_margin_check``."""
    import copy

    import torch

    from pytorch_distributed_training_tpu_torch.models.gpt2 import (
        GPT2LMModel,
    )
    from pytorch_distributed_training_tpu_torch.utils.config import (
        model_preset,
    )

    base = GPT2LMModel(
        model_preset(model_name, attention_impl="reference"),
        generator=torch.Generator().manual_seed(seed),
    ).to(device)
    models = {}
    for weights in sorted({r[2] for r in runs.values()}):
        models[weights] = copy.deepcopy(base)
        models[weights].cast_for_serving(weights)
        models[weights].eval()
    del base
    out = {name: margin_check(models[weights], name, toks, prompts, tol,
                              device, weights=weights)
           for name, (toks, prompts, weights, tol) in runs.items()}
    for name, toks, prompt, req in sampled:
        out[name] = sampled_margin_check(models["float32"], name, toks,
                                         prompt, req, MARGIN_TOL, device)
    del models
    return out


def margin_check(model, name, toks, prompts, tol, device, **extra) -> dict:
    """Each token of ``toks`` (request id -> token ids, greedy) against a
    full-sequence forward of ``model`` on its prompt and the tokens before
    it: it must trail that forward's maximum logit by at most ``tol``."""
    import torch

    from pytorch_distributed_training_tpu_torch.data.bpe import ByteTokenizer

    tok = ByteTokenizer()
    agree = total = 0
    worst = 0.0
    with torch.inference_mode():
        for i, p in enumerate(prompts):
            served = toks[f"r{i}"]
            ids = tok.text_ids(p) + served[:-1]
            logits = model(torch.tensor([ids], device=device))[0]
            if not torch.isfinite(logits).all():
                raise AssertionError(f"{name} r{i}: non-finite logits")
            rows = logits[len(ids) - len(served):]
            picked = rows.gather(
                1, torch.tensor(served, device=device)[:, None])
            margin = (rows.max(dim=1).values - picked[:, 0]).float()
            worst = max(worst, float(margin.max()))
            agree += int((margin == 0).sum())
            total += len(served)
    if worst > tol:
        raise AssertionError(
            f"{name}: a served token trails the full-sequence "
            f"maximum by {worst} (> {tol})"
        )
    out = dict(tokens=total, argmax_agree=agree, worst_margin=worst,
               tolerance=tol, **extra)
    say(f"[check] {name}: served vs full-sequence forward: "
        + json.dumps(out))
    return out


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


def ln_bwd_times(x, dy, scale, bias, eps) -> dict:
    """Kernel 2, its plain version and ``native_layer_norm_backward`` (the
    library call, bf16 scale/bias, all three gradients) at x's shape."""
    import torch

    from pytorch_distributed_training_tpu_torch.ops.layer_norm import (
        _layer_norm_bwd_cuda,
        reference_layer_norm_bwd,
    )

    rows, h = x.shape
    sb, bb = scale.bfloat16(), bias.bfloat16()
    _, mean, rstd = torch.ops.aten.native_layer_norm(x, [h], sb, bb, eps)
    t = dict(
        ms=time_ms(lambda: _layer_norm_bwd_cuda(x, dy, scale, eps=eps)),
        plain_ms=time_ms(lambda: reference_layer_norm_bwd(x, dy, scale,
                                                          eps=eps)),
        library_ms=time_ms(lambda: torch.ops.aten.native_layer_norm_backward(
            dy, x, [h], mean, rstd, sb, bb, [True, True, True])),
    )
    t["bound_ms"], t["bound_by"] = bound(
        rows * h * x.element_size() * 3 + 3 * h * 4, 12.0 * rows * h)
    return t


def ln_bwd_phase(device, shapes=LN_BWD_SHAPES, eps=1e-12,
                 timed_rows=(MAIN_ROWS, 4096)) -> dict:
    """Kernel 2 through ``torch.autograd.grad`` of the port's LayerNorm
    against autograd through the plain forward, on bf16 and float32 x; x
    and dy off 16 bytes (single-element chunks); two calls bit-identical;
    times at ``timed_rows`` x MAIN_H."""
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

    def check(what, x, dy, got, want):
        nonlocal worst, worst_sum
        worst = max(worst, check_ln_close(what + " dx", got[0], want[0]))
        dyf, xh = dy.float(), _xhat(x, eps)
        worst_sum = max(
            worst_sum,
            check_sums(what + " dscale", got[1], want[1],
                       (dyf * xh).abs().sum(0)),
            check_sums(what + " dbias", got[2], want[2], dyf.abs().sum(0)),
        )

    for rows, hidden in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            x, dy, scale, bias = _ln_train_inputs(g, rows, hidden, device)
            x = x.to(dtype)
            kw = dict(eps=eps, out_dtype=torch.bfloat16)
            _, got = _grads(functools.partial(layer_norm, **kw),
                            (x, scale, bias), dy)
            _, want = _grads(functools.partial(reference_layer_norm, **kw),
                             (x, scale, bias), dy)
            what = f"layer_norm_bwd rows={rows} H={hidden} {dtype}"
            check(what, x, dy, got, want)
            dyc = dy.to(dtype)
            once = _layer_norm_bwd_cuda(x, dyc, scale, eps=eps)
            again = _layer_norm_bwd_cuda(x, dyc, scale, eps=eps)
            for name, a, b in zip(("dx", "dscale", "dbias"), once, again):
                same_bits(f"{what} {name}", a, b)
            if rows in (8, MAIN_ROWS) and hidden in (64, MAIN_H):
                xo, dyo = _off16(x), _off16(dyc)
                check(what + " (x, dy off 16 bytes)", x, dyc,
                      _layer_norm_bwd_cuda(xo, dyo, scale, eps=eps),
                      reference_layer_norm_bwd(x, dyc, scale, eps=eps))
    say(f"[kernels] layer_norm_bwd parity ok: {list(shapes)} x {{bf16, "
        f"f32}}, and x, dy off 16 bytes; dx max abs err {worst} (<= 1 bf16 "
        f"ulp + {LN_FP32_SLACK}), dscale/dbias max err {worst_sum} of the "
        f"column's sum |terms| (<= {PARAM_SUM_SLACK}); two calls "
        f"bit-identical")
    timings = {}
    for rows in timed_rows:
        x, dy, scale, bias = _ln_train_inputs(g, rows, MAIN_H, device)
        timings[rows] = ln_bwd_times(x, dy, scale, bias, eps)
        say(f"[kernels] layer_norm_bwd rows={rows} H={MAIN_H} bf16: "
            + json.dumps(timings[rows]))
    return dict(max_abs_err=worst, **timings[MAIN_ROWS],
                **{f"rows_{n}": t for n, t in timings.items()})


def dal_bound(rows, hidden, *, n_rows_io, params, rate, kernel="dal_fwd"):
    """Least time of a dropout-add-LayerNorm call: ``n_rows_io`` bf16
    [rows, hidden] tensors read or written once, ``params`` float32 [hidden]
    vectors; 16 float operations an element (20 in the backward are within
    rounding of it) at the float32 rate, and at rate > 0 the Philox mask's
    integer instructions (``kernel``'s PHILOX_INT_PER_ELEMENT) at the
    integer rate."""
    n = rows * hidden
    return bound(n_rows_io * n * 2 + params * hidden * 4, 16.0 * n,
                 int_instr=philox_int(kernel, n) if rate > 0 else 0.0)


def dal_phase(device, shapes=LN_BWD_SHAPES, rate=DROPOUT_RATE, eps=1e-12,
              eval_rows=DAL_EVAL_ROWS) -> tuple[dict, dict]:
    """Kernels 3 and 4: the forward's mask against the plain generator bit
    for bit (h = 1, x = 0 makes s the mask-scale itself), s bit for bit at
    random inputs, y and the gradients through ``torch.autograd.grad``
    against the plain forward and backward under autograd (both save s in
    bf16), dh exactly 0 where h was dropped, two calls bit-identical; at
    H 64-2048 and 1001 (single-element chunks), on inputs off 16 bytes, at
    rate 0, without s (eval), and for every (h, y) dtype pair. Times at
    the training shape (MAIN_ROWS x MAIN_H, rate 0.1, s saved; the
    backward's two passes also one by one) and the eval forward
    (``eval_rows`` x MAIN_H, rate 0, no s)."""
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
    bf16, f32 = torch.bfloat16, torch.float32
    worst = worst_sum = 0.0

    def check_bwd(what, s, dy, got, want, keep):
        nonlocal worst, worst_sum
        worst = max(worst, check_ln_close(what + " dh", got[0], want[0]),
                    check_ln_close(what + " dx", got[1], want[1]))
        if keep is not None and not torch.equal(
                got[0][~keep], torch.zeros_like(got[0][~keep])):
            raise AssertionError(f"{what}: dh is not 0 where h dropped")
        dyf, xh = dy.float(), _xhat(s, eps)
        worst_sum = max(
            worst_sum,
            check_sums(what + " dscale", got[2], want[2],
                       (dyf * xh).abs().sum(0)),
            check_sums(what + " dbias", got[3], want[3], dyf.abs().sum(0)),
        )

    def check_pair(what, h, x, dy, scale, bias, kw, out_dtype, keep):
        """The kernels' forward (y, s) and backward against the plain ones
        on the same s, each call twice bit-identical."""
        nonlocal worst
        fwd = functools.partial(_dal_fwd_cuda, h, x, scale, bias,
                                out_dtype=out_dtype, **kw)
        y_k, s_k = fwd(save_s=True)
        y_p, s_p = reference_dal_fwd(h, x, scale, bias, out_dtype=out_dtype,
                                     **kw)
        if not torch.equal(s_k, s_p):
            raise AssertionError(f"{what}: saved s differs from the plain "
                                 f"version's")
        worst = max(worst, check_ln_close(what + " y", y_k, y_p))
        y_e, s_e = fwd(save_s=False)
        if s_e is not None:
            raise AssertionError(f"{what}: s returned with save_s=False")
        for name, a, b in (("y", y_k, fwd(save_s=True)[0]),
                           ("s", s_k, fwd(save_s=True)[1]),
                           ("y without s", y_k, y_e)):
            same_bits(f"{what} {name}", a, b)
        bwd = functools.partial(_dal_bwd_cuda, s_k, dy.to(h.dtype), scale,
                                **kw)
        got = bwd()
        check_bwd(what + "_bwd", s_k, dy.to(h.dtype), got,
                  reference_dal_bwd(s_k, dy.to(h.dtype), scale, **kw), keep)
        for name, a, b in zip(("dh", "dx", "dscale", "dbias"), got, bwd()):
            same_bits(f"{what}_bwd {name}", a, b)

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
        check_pair(what, h, x, dy, scale, bias, kw, bf16, keep)
        # the autograd Function of the entry point, against the plain one
        y_k, got = _grads(functools.partial(dropout_add_layer_norm,
                                            out_dtype=bf16, **kw),
                          (h, x, scale, bias), dy)
        y_p, want = _grads(functools.partial(reference_dropout_add_layer_norm,
                                             out_dtype=bf16, **kw),
                           (h, x, scale, bias), dy)
        worst = max(worst, check_ln_close(what + " y (autograd)", y_k, y_p))
        _, s_p = reference_dal_fwd(h, x, scale, bias, out_dtype=bf16, **kw)
        check_bwd(what + "_bwd (autograd)", s_p, dy, got, want, keep)
        if rows in (8, MAIN_ROWS) and hidden in (64, MAIN_H):
            check_pair(what + " (inputs off 16 bytes)", _off16(h), _off16(x),
                       _off16(dy), scale, bias, kw, bf16, keep)
        if hidden in (64, MAIN_H, 1001) and rows in (8, 1000, MAIN_ROWS):
            kw0 = dict(kw, rate=0.0)
            check_pair(what + " rate 0", h, x, dy, scale, bias, kw0, bf16,
                       None)
    # every (h, y) dtype pair the kernels take
    rows, hidden = 1000, 768
    x, dy, scale, bias = _ln_train_inputs(g, rows, hidden, device)
    hf = torch.randn(rows, hidden, generator=g, device=device)
    kw = dict(rate=rate, seed=21, site=0, eps=eps)
    keep = keep_mask((rows, hidden), rate, 21, 0, device)
    for in_dtype, out_dtype in ((bf16, f32), (f32, f32), (f32, bf16)):
        check_pair(f"dropout_add_layer_norm rows={rows} H={hidden} "
                   f"{in_dtype} -> {out_dtype}", hf.to(in_dtype),
                   x.to(in_dtype), dy, scale, bias, kw, out_dtype, keep)
    say(f"[kernels] dropout_add_layer_norm fwd/bwd parity ok: "
        f"{list(shapes)} bf16, rate {rate} (inputs off 16 bytes at 8 and "
        f"{MAIN_ROWS} rows; rate 0; y without s; bf16/f32 in and out at "
        f"{rows} x {hidden}): masks and s identical to the plain version, "
        f"y/dh/dx max abs err {worst} (<= 1 bf16 ulp + {LN_FP32_SLACK}), "
        f"dh 0 where h dropped, dscale/dbias max err {worst_sum} of sum "
        f"|terms| (<= {PARAM_SUM_SLACK}); two calls bit-identical")

    x, dy, scale, bias = _ln_train_inputs(g, MAIN_ROWS, MAIN_H, device)
    h = torch.randn(MAIN_ROWS, MAIN_H, generator=g, device=device).bfloat16()
    kw = dict(rate=rate, seed=77, site=0, eps=eps)
    _, s = _dal_fwd_cuda(h, x, scale, bias, out_dtype=bf16, save_s=True,
                         **kw)
    fwd = dict(
        ms=time_ms(lambda: _dal_fwd_cuda(h, x, scale, bias, out_dtype=bf16,
                                         save_s=True, **kw)),
        plain_ms=time_ms(lambda: reference_dal_fwd(h, x, scale, bias,
                                                   out_dtype=bf16, **kw)),
        library_ms=None,
    )
    fwd["bound_ms"], fwd["bound_by"] = dal_bound(
        MAIN_ROWS, MAIN_H, n_rows_io=4, params=2, rate=rate)
    bwd = dict(
        ms=time_ms(lambda: _dal_bwd_cuda(s, dy, scale, **kw)),
        plain_ms=time_ms(lambda: reference_dal_bwd(s, dy, scale, **kw)),
        library_ms=None,
        kernel_ms=kernel_ms_by_symbol(lambda: _dal_bwd_cuda(s, dy, scale,
                                                            **kw)),
    )
    bwd["bound_ms"], bwd["bound_by"] = dal_bound(
        MAIN_ROWS, MAIN_H, n_rows_io=4, params=3, rate=rate,
        kernel="dal_bwd_dx")
    # the eval forward: rate 0, no s
    x, _, scale, bias = _ln_train_inputs(g, eval_rows, MAIN_H, device)
    h = torch.randn(eval_rows, MAIN_H, generator=g, device=device).bfloat16()
    kw0 = dict(rate=0.0, seed=0, site=0, eps=eps, out_dtype=bf16)
    ev = dict(
        ms=time_ms(lambda: _dal_fwd_cuda(h, x, scale, bias, save_s=False,
                                         **kw0)),
        plain_ms=time_ms(lambda: reference_dal_fwd(h, x, scale, bias,
                                                   **kw0)),
        library_ms=None,
    )
    ev["bound_ms"], ev["bound_by"] = dal_bound(
        eval_rows, MAIN_H, n_rows_io=3, params=2, rate=0.0)
    say(f"[kernels] dropout_add_layer_norm rows={MAIN_ROWS} H={MAIN_H} bf16 "
        f"rate {rate}, training forward: " + json.dumps(fwd))
    say(f"[kernels] dropout_add_layer_norm rows={eval_rows} H={MAIN_H} bf16 "
        f"rate 0, eval forward (no s): " + json.dumps(ev))
    say(f"[kernels] dropout_add_layer_norm_bwd rows={MAIN_ROWS} H={MAIN_H}: "
        + json.dumps(bwd))
    say("[kernels] dropout_add_layer_norm(_bwd) library_ms null: no single "
        "PyTorch call computes dropout + residual add + LayerNorm")
    return (dict(max_abs_err=worst, **fwd, eval=ev),
            dict(max_abs_err=worst, **bwd))


def same_bits_or_nan(what, got, want) -> None:
    """Bit for bit, where ``want`` is NaN only NaN (its payload aside)."""
    import torch

    nan = torch.isnan(want)
    if got.dtype != want.dtype or got.shape != want.shape or not (
            torch.equal(torch.isnan(got), nan) and torch.equal(
                got.masked_fill(nan, 0).view(torch.int16 if got.itemsize == 2
                                             else torch.int32),
                want.masked_fill(nan, 0).view(torch.int16 if want.itemsize
                                              == 2 else torch.int32))):
        raise AssertionError(f"{what}: differs from the plain version")


def mask_scale_phase(device, shapes=MASK_PARITY_SHAPES, timed=APPLY_SHAPES,
                     rate=DROPOUT_RATE) -> tuple[dict, dict]:
    """Kernel 5's two modes against the plain versions, bit for bit: the
    mask-scale (mask-only) and ``x * mask-scale`` (apply, on x at its
    place and one element past 16 bytes: the scalar path; x holding NaN
    and infinities), bf16 and float32, two calls bit-identical; the
    forward and gradient of ``raw_dropout`` against autograd of the plain
    product. Times mask-only at BERT's probs and apply at ``timed``
    beside the two-launch pair (mask-only, then an aten mul), the plain
    version and ``F.dropout``."""
    import torch
    import torch.nn.functional as F

    from pytorch_distributed_training_tpu_torch.ops.dropout import (
        _apply_cuda,
        _mask_scale_cuda,
        mask_scale,
        raw_dropout,
        reference_mask_scale,
    )

    g = torch.Generator(device=device).manual_seed(13)
    bf16 = torch.bfloat16
    for i, shape in enumerate(shapes):
        for dtype in (bf16, torch.float32):
            kw = dict(seed=500 + i, site=2)
            what = f"{shape} {dtype}"
            m = reference_mask_scale(shape, rate, dtype, device=device, **kw)
            for _ in range(2):
                same_bits_or_nan(f"mask_scale {what}", mask_scale(
                    shape, rate, dtype, device=device, **kw), m)
            x = torch.randn(shape, generator=g, device=device).to(dtype)
            flat = x.view(-1)
            flat[::97] = float("nan")
            flat[1::89] = float("inf")
            flat[2::83] = -float("inf")
            want = x * m
            for xin, where in ((x, "aligned"), (_off16(x), "off 16 bytes")):
                for _ in range(2):
                    same_bits_or_nan(f"apply {what} {where}", _apply_cuda(
                        xin, rate, kw["seed"], kw["site"]), want)
            x = torch.randn(shape, generator=g, device=device).to(dtype)
            dy = torch.randn(shape, generator=g, device=device).to(dtype)
            xk = x.clone().requires_grad_()
            yk = raw_dropout(xk, rate, **kw)
            yk.backward(dy)
            xp = x.clone().requires_grad_()
            yp = xp * m
            yp.backward(dy)
            same_bits_or_nan(f"raw_dropout {what}", yk.detach(), yp.detach())
            same_bits_or_nan(f"raw_dropout gradient {what}", xk.grad,
                             xp.grad)
    say(f"[kernels] mask_scale / mask_scale_apply parity ok: "
        f"{list(shapes)} x {{bf16, f32}}: the mask-scale and x * mask-scale "
        f"(x aligned and off 16 bytes, with NaN and +-inf) identical to the "
        f"plain version's bits (NaN where it is NaN), two calls "
        f"bit-identical; raw_dropout's output and gradient identical to "
        f"autograd of the plain product")
    probs = shapes[0]
    n = math.prod(probs)
    ones = torch.ones(probs, dtype=bf16, device=device)
    kw = dict(seed=9, site=2, device=device)
    mask = dict(
        ms=time_ms(lambda: mask_scale(probs, rate, bf16, **kw)),
        plain_ms=time_ms(lambda: reference_mask_scale(probs, rate, bf16,
                                                      **kw)),
        library_ms=time_ms(lambda: F.dropout(ones, rate, training=True)),
    )
    # the output written once; the mask's integer instructions
    mask["bound_ms"], mask["bound_by"] = bound(
        n * 2, 0.0, int_instr=philox_int("mask_scale", n))
    say(f"[kernels] mask_scale {probs} bf16 rate {rate}: "
        + json.dumps(mask))
    applied = {}
    for shape in timed:
        x = torch.randn(shape, generator=g, device=device).to(bf16)
        n = math.prod(shape)
        t = dict(
            ms=time_ms(lambda: _apply_cuda(x, rate, 9, 2)),
            pair_ms=time_ms(lambda: x * _mask_scale_cuda(shape, rate, bf16,
                                                         9, 2, device)),
            plain_ms=time_ms(lambda: x * reference_mask_scale(
                shape, rate, bf16, **kw)),
            library_ms=time_ms(lambda: F.dropout(x, rate, training=True)),
        )
        # x read and y written once, a multiply an element, the mask's
        # integer instructions
        t["bound_ms"], t["bound_by"] = bound(
            n * 4, float(n), int_instr=philox_int("mask_scale_apply", n))
        applied[str(list(shape))] = t
        say(f"[kernels] mask_scale_apply {list(shape)} bf16 rate {rate} "
            f"(pair_ms: mask_scale then an aten mul): " + json.dumps(t))
    return (dict(max_abs_err=0.0, **mask),
            dict(max_abs_err=0.0, **applied[str(list(probs))],
                 shapes=applied))


def dropout_modes_phase(device, shapes=MASK_PARITY_SHAPES, timed=APPLY_SHAPES,
                        rate=DROPOUT_RATE) -> dict:
    """Kernel 5's bits8 and exact modes against their plain versions
    (``ops/dropout.reference_dropout``), bit for bit, at the mask parity
    shapes (odd tails included), on x at its place and one element past 16
    bytes, holding NaN and infinities, bf16 and float32, two calls
    bit-identical; the NaN contract checked (exact: a dropped NaN is 0,
    bits8: it stays NaN); ``raw_dropout``'s output and gradient against
    autograd of the plain version. Timed at ``timed`` beside the plain
    version and ``F.dropout``; the bound from this run's SASS."""
    import torch
    import torch.nn.functional as F

    from pytorch_distributed_training_tpu_torch.ops import dropout as drop

    g = torch.Generator(device=device).manual_seed(17)
    bf16 = torch.bfloat16
    res = {}
    for impl in ("bits8", "exact"):
        kernel = drop.STREAM_KERNELS[impl]
        keep_fn = drop.bits8_keep if impl == "bits8" else drop.exact_keep
        for i, shape in enumerate(shapes):
            for dtype in (bf16, torch.float32):
                seed, site, what = 700 + i, 2, f"{impl} {shape} {dtype}"
                x = torch.randn(shape, generator=g, device=device).to(dtype)
                flat = x.view(-1)
                flat[::97] = float("nan")
                flat[1::89] = float("inf")
                flat[2::83] = -float("inf")
                want = drop.reference_dropout(x, rate, seed, site, impl)
                for xin, where in ((x, "aligned"), (_off16(x), "off 16 "
                                                         "bytes")):
                    for _ in range(2):
                        same_bits_or_nan(f"{what} {where}", drop._apply_cuda(
                            xin, rate, seed, site, impl), want)
                keep = keep_fn(shape, rate, seed, site, device)
                nan_in = torch.isnan(x)
                nan_out = torch.isnan(want)
                if impl == "exact" and not torch.equal(nan_out,
                                                       nan_in & keep):
                    raise AssertionError(f"{what}: a dropped NaN is not 0")
                if impl == "bits8" and (nan_in & ~nan_out).any():
                    raise AssertionError(f"{what}: a NaN was quenched")
                x = torch.randn(shape, generator=g, device=device).to(dtype)
                dy = torch.randn(shape, generator=g, device=device).to(dtype)
                xk = x.clone().requires_grad_()
                yk = drop.raw_dropout(xk, rate, seed, site, impl)
                yk.backward(dy)
                same_bits_or_nan(f"raw_dropout {what}", yk.detach(),
                                 drop.reference_dropout(x, rate, seed, site,
                                                        impl))
                same_bits_or_nan(f"raw_dropout gradient {what}", xk.grad,
                                 drop.reference_dropout(dy, rate, seed, site,
                                                        impl))
        say(f"[kernels] {kernel} parity ok: {list(shapes)} x {{bf16, f32}}: "
            f"x aligned and off 16 bytes, with NaN and +-inf, identical to "
            f"the plain version's bits, two calls bit-identical, the NaN "
            f"contract held ({'select' if impl == 'exact' else 'multiply'}"
            f"); raw_dropout's output and gradient identical to the plain "
            f"version's")
        applied = {}
        for shape in timed:
            x = torch.randn(shape, generator=g, device=device).to(bf16)
            n = math.prod(shape)
            t = dict(
                ms=time_ms(lambda: drop._apply_cuda(x, rate, 9, 2, impl)),
                plain_ms=time_ms(lambda: drop.reference_dropout(
                    x, rate, 9, 2, impl)),
                library_ms=time_ms(lambda: F.dropout(x, rate,
                                                     training=True)),
            )
            # x read and y written once, a multiply (a division) an
            # element, the mask's integer instructions
            t["bound_ms"], t["bound_by"] = bound(
                n * 4, float(n), int_instr=philox_int(kernel, n))
            applied[str(list(shape))] = t
            say(f"[kernels] {kernel} {list(shape)} bf16 rate {rate}: "
                + json.dumps(t))
        res[kernel] = dict(max_abs_err=0.0, **applied[str(list(timed[0]))],
                           shapes=applied)
    return res


# ------------------------------------------------------------ phase 4, 5


def expected_train_launches(*, micro: int, eval_batches: int,
                            layers: int, flash: bool = False,
                            calibration: tuple = (0, 0),
                            roberta: bool = False) -> dict:
    """Launches of a counted train run, ``layers`` the trunk layers a
    forward runs (the branch ensemble's: every branch's): per microbatch
    forward the embeddings LN, 2 tails per layer and 2 + layers dropouts
    (embeddings, classifier, the probs of each layer; ``roberta``: the
    pooler's pre-dropout too); per backward the LN and tail backwards, the
    probs dropouts again (attention_remat recomputes the core) and each
    dropout's backward (the mask drawn again, applied to dy); per eval
    batch the forwards, deterministic. ``flash`` (seq <= 256): the
    whole-sequence flash pair a layer instead, with the probs dropout
    inside, so 2 dropouts a forward. No mask-scale tensor is made.
    ``calibration``: the deterministic (forwards, backwards) of the
    delayed-int8 calibration before step 0."""
    fwd, bwd = micro + eval_batches + calibration[0], micro + calibration[1]
    head = 2 * (2 + roberta)  # the head's sites, each way
    out = {
        "layer_norm": fwd,
        "layer_norm_bwd": bwd,
        "dropout_add_layer_norm": 2 * layers * fwd,
        "dropout_add_layer_norm_bwd": 2 * layers * bwd,
        "mask_scale_apply": (head + 3 * layers) * micro,
    }
    if flash:
        out.update(flash_whole_fwd=layers * fwd, flash_whole_bwd=layers * bwd,
                   mask_scale_apply=head * micro)
    return out


def stream_launches(*, micro: int, eval_batches: int, layers: int,
                    impl: str, ln: str) -> dict:
    """Launches of a counted RoBERTa run (reference attention) under the
    stream ``impl`` and ``layernorm_impl`` ``ln`` (``ops/layer_norm.py``):
    a train step's tails are unfused (``raw_dropout`` in the stream, the
    add, the LayerNorm: kernels 1 and 2 under ``"fused"``, none under
    ``"reference"``), so kernels 3 and 4 launch only in the eval, where a
    deterministic tail under ``"fused"`` takes kernel 3; every dropout
    site (embeddings, pooler, classifier, the probs, the two tails)
    launches the stream's mode each way, the probs once more in their
    recompute."""
    from pytorch_distributed_training_tpu_torch.ops.dropout import (
        STREAM_KERNELS,
    )

    fused = ln == "fused"
    fwd, bwd = micro + eval_batches, micro
    # forward, the probs' recompute, backward
    sites = (3 + 3 * layers) + layers + (3 + 3 * layers)
    want = {
        "layer_norm": (fwd + 2 * layers * micro) * fused,
        "layer_norm_bwd": (1 + 2 * layers) * bwd * fused,
        "dropout_add_layer_norm": 2 * layers * eval_batches * fused,
        STREAM_KERNELS[impl]: sites * micro,
    }
    return {k: v for k, v in want.items() if v}


def calibration_passes(mc) -> tuple:
    """(forwards, backwards) of the Trainer's delayed-int8 calibration
    (``train/loop.py``): two passes, each a forward and, with delayed dy
    scales, one more forward and its backward."""
    if mc.matmul_impl == "native" or not mc.quant_delayed:
        return (0, 0)
    grads = int(mc.quant_delayed_grads)
    return (2 * (1 + grads), 2 * grads)


def eval_batches(trainer) -> int:
    """The eval batches of one evaluation, over every split (MNLI's
    two)."""
    return sum(lo.steps_per_epoch for lo in trainer.eval_loaders.values())


def train_launches(trainer) -> dict:
    """``expected_train_launches`` of a finished classification run (its
    microbatches: each pipeline microbatch under the schedules)."""
    tc, mc = trainer.tcfg, trainer.mcfg
    return expected_train_launches(
        micro=trainer.state.step * tc.grad_accum_steps * trainer.n_micro,
        eval_batches=eval_batches(trainer),
        layers=mc.num_layers * getattr(trainer.state.module, "n_branches", 1),
        flash=mc.attention_impl == "flash",
        calibration=calibration_passes(mc), roberta=mc.roberta_style)


def initial_weights(trainer) -> dict:
    """The weights of step 0 of a classification run, made again from the
    seed on the CPU."""
    import torch

    from pytorch_distributed_training_tpu_torch.models.bert import (
        BertForSequenceClassification,
    )
    from pytorch_distributed_training_tpu_torch.models.branch import (
        BranchEnsembleClassifier,
    )

    tc, mc, module = trainer.tcfg, trainer.mcfg, trainer.state.module
    if isinstance(module, BranchEnsembleClassifier):
        return BranchEnsembleClassifier(mc, module.n_branches,
                                        seed=tc.seed).state_dict()
    return BertForSequenceClassification(
        mc, generator=torch.Generator().manual_seed(tc.seed)).state_dict()


def check_branches_differ(start: dict, n_branches: int) -> None:
    """Every tensor of every branch starts unlike the same tensor of each
    other branch."""
    import torch

    names = [k[len("branches.0."):] for k in start
             if k.startswith("branches.0.")]
    for a in range(n_branches):
        for b in range(a + 1, n_branches):
            same = [n for n in names
                    if torch.equal(start[f"branches.{a}.{n}"],
                                   start[f"branches.{b}.{n}"])
                    and start[f"branches.{a}.{n}"].std() > 0]
            if same:
                raise AssertionError(f"branches {a} and {b} start alike: "
                                     f"{same[:5]}")


@contextlib.contextmanager
def strict_guards():
    """``PDT_TPU_GUARDS=strict`` inside: the trainer's runtime guards raise
    on a recompile or an implicit transfer (``analysis/guards.py``)."""
    prev = os.environ.get("PDT_TPU_GUARDS")
    os.environ["PDT_TPU_GUARDS"] = "strict"
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("PDT_TPU_GUARDS")
        else:
            os.environ["PDT_TPU_GUARDS"] = prev


def check_train_guards(what, trainer, audits=True) -> dict:
    """The trainer ran under strict guards with no violation, its warm
    start's ``compile`` record made before its first step, and (``audits``)
    its sharding and first-step collective audits ok."""
    g = trainer.guards
    got = dict(mode=g.mode, recompiles=g.recompile_violations,
               implicit_transfers=g.transfer_violations,
               calls={k: v.calls for k, v in g.wrapped.items()},
               compile=trainer.compile_record)
    bad = (g.mode != "strict" or g.violations
           or trainer.compile_record is None)
    if audits:
        got.update(sharding_ok=trainer.sharding_record["ok"],
                   comm_ok=trainer.comm_record["ok"],
                   comm_count=trainer.comm_record["count"])
        bad = bad or not (got["sharding_ok"] and got["comm_ok"])
    if bad:
        raise AssertionError(f"{what}: guards {got}")
    return got


@contextlib.contextmanager
def no_mask_tensor(what):
    """Fails when the plain mask-scale is made inside: on the card every
    dropout site applies its mask in the kernel's one pass (and the
    counted runs want no mask-only launch), so no site multiplies by a
    mask-scale tensor."""
    from pytorch_distributed_training_tpu_torch.ops import dropout

    plain, made = dropout.reference_mask_scale, []

    def counted(*args, **kwargs):
        made.append(args[0])
        return plain(*args, **kwargs)

    dropout.reference_mask_scale = counted
    try:
        yield
    finally:
        dropout.reference_mask_scale = plain
    if made:
        raise AssertionError(f"{what}: {len(made)} plain mask-scale tensors "
                             f"made on the card (shapes {made[:3]})")


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


def engine(trainer) -> str:
    """The train loader's engine: native (the C++ batcher) or python, and
    the prefetch depth."""
    from pytorch_distributed_training_tpu_torch.data.native_loader import (
        NativeShardedLoader,
    )

    loader, depth = trainer.train_loader, 0
    if hasattr(loader, "inner"):
        loader, depth = loader.inner, trainer.train_loader.depth
    kind = "native" if isinstance(loader, NativeShardedLoader) else "python"
    return f"{kind}, prefetch {depth}"


def data_wait_p50(trainer):
    """The median ``train/data_wait_s`` of the trainer's last epoch."""
    return trainer.last_telemetry["timers"]["train/data_wait_s"]["p50_s"]


def moment_bytes(trainer) -> int:
    opt = trainer.state.optimizer
    return sum(m.numel() * m.element_size()
               for g in opt.param_groups for p in g["params"]
               for m in opt.moments(p))


def train_metrics(trainer, wall) -> dict:
    rec = trainer.history[-1]
    steps = len(trainer.step_log)
    return dict(
        wall_s=wall, steps=steps, samples_per_s=rec["samples_per_sec"],
        ms_per_step=1e3 * trainer.tcfg.global_batch_size
        / rec["samples_per_sec"],
        losses=[s["loss"] for s in trainer.step_log],
        grad_norms=[s["grad_norm"] for s in trainer.step_log],
        **{k: v for k, v in rec.items()
           if k.startswith("accuracy") or k == "f1"},
        engine=engine(trainer), data_wait_p50_s=data_wait_p50(trainer),
    )


def train_phase(argv=TRAIN_ARGS, cli="train_dp", tag="train",
                steps=3) -> dict:
    """A classification main path (``train_dp``, or ``train_mp``'s branch
    ensemble), counted (first run, cold, on the C++ batch assembler with
    prefetch: ``--native-loader on``, so a batcher that does not build
    fails the run), then a second run from the same seed on the Python
    loader without prefetch (``--native-loader off --prefetch-depth 0``)
    that must give bit-identical per-step losses: determinism and the two
    engines' equality in one rerun."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    with no_mask_tensor(f"{tag} run"), strict_guards():
        trainer, counts, wall = train_once(argv + NATIVE_ON, cli)
    peak = torch.cuda.max_memory_allocated()
    guards = check_train_guards(f"{tag} run", trainer)
    tc, mc = trainer.tcfg, trainer.mcfg
    branches = getattr(trainer.state.module, "n_branches", 1)
    check_launches(
        f"{tag} run ({trainer.state.step} steps x {tc.grad_accum_steps} "
        f"microbatches, {trainer.eval_loader.steps_per_epoch} eval batches, "
        f"{branches} branch(es))", counts, train_launches(trainer))
    cold = train_metrics(trainer, wall)
    if cold["steps"] != steps or not all(
            map(math.isfinite, cold["losses"] + cold["grad_norms"])):
        raise AssertionError(f"{tag} run: {cold}")
    start = initial_weights(trainer)
    if branches > 1:
        check_branches_differ(start, branches)
    now = trainer.state.module.state_dict()
    unmoved = [k for k in start
               if torch.equal(now[k].cpu(), start[k])]
    if unmoved:
        raise AssertionError(f"{tag}: parameters unchanged after {steps} "
                             f"steps: {unmoved[:5]}")
    del trainer, start, now
    gc.collect()
    torch.cuda.empty_cache()
    cold.update(peak_mem_bytes=peak, launches=counts,
                layers=mc.num_layers, hidden=mc.hidden_size,
                branches=branches, guards=guards)
    say(f"[{tag}] cold run: " + json.dumps(cold))
    with strict_guards():
        trainer, _, wall = train_once(argv + PYTHON_LOADER, cli)
    warm = train_metrics(trainer, wall)
    warm["guards"] = check_train_guards(f"{tag} warm run", trainer)
    # the eval alone once more, timed: the profile's busy share needs the
    # warm run's device-side seconds (steps + eval)
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
    say(f"[{tag}] per-step losses bit-identical across two runs "
        f"({cold['engine']}; {warm['engine']}); train/data_wait_s median "
        f"{cold['data_wait_p50_s']:.6f} s and {warm['data_wait_p50_s']:.6f}"
        f" s")
    return dict(cold, warm=warm)


def one_step(argv, rows=PROFILE_TRAIN_SIZE):
    """``argv`` with the train rows cut to one step (the profile depth):
    ``rows`` = the global batch."""
    at = argv.index("--train-size") + 1
    return argv[:at] + [rows] + argv[at + 1:]


def train_profile_phase(warm, argv=TRAIN_ARGS, cli="train_dp",
                        tag="train-profile", env=None, forbid=()) -> dict:
    """Device kernel time of the steps and the eval under
    ``torch.profiler``, by kernel class (the trainer is built first, so
    the weight copy to the card is outside the window), and its share of
    the warm run's seconds for as many steps and its eval (``warm`` None:
    of the profiled wall, which the profiler's host cost inflates);
    ``env`` is set in the environment around the run; a device kernel
    whose name holds a ``forbid`` symbol fails the phase."""
    import importlib

    from torch.profiler import ProfilerActivity, profile

    module = importlib.import_module(
        f"pytorch_distributed_training_tpu_torch.cli.{cli}")
    trainer = module.build_trainer(module.build_parser().parse_args(argv))
    saved = {k: os.environ.get(k) for k in env or {}}
    os.environ.update(env or {})
    try:
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            trainer.run()
        wall = time.perf_counter() - t0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    steps = len(trainer.step_log)
    del trainer
    from torch.autograd import DeviceType

    # aggregated once: each call walks every event again (seconds)
    averages = profile_averages(prof)
    bad = sorted({e.key[:90] for e in averages
                  if e.device_type == DeviceType.CUDA
                  and any(sym in e.key for sym in forbid)})
    if bad:
        raise AssertionError(f"{tag}: launched {bad}, none wanted")
    base = (f"warm run's ms a step x {steps} + eval" if warm
            else "profiled wall")
    res = dict(device_time_by_class(
        averages, warm["ms_per_step"] * steps / 1e3 + warm["eval_s"] if warm
        else wall),
        busy_share_of=base, profiled_wall_s=wall, profiled_steps=steps,
        host=host_time_by_op(averages))
    say(f"[{tag}] " + json.dumps(res))
    return res


def host_time_by_op(averages, top_n=12) -> dict:
    """Host self time of a ``torch.profiler`` run (its ``profile_averages``)
    by operator (the main thread and autograd's backward thread together),
    the largest first, and the number of kernel launches the host
    issued."""
    from torch.autograd import DeviceType

    ops = [e for e in averages
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


@contextlib.contextmanager
def offline_datasets():
    """A stand-in ``datasets`` module in ``sys.modules`` whose
    ``load_dataset`` raises ``ConnectionError``, as on an image without
    network: the card's machine has no ``datasets`` package, and the
    loader's own fallback then yields the synthetic task."""
    import types

    def load_dataset(*args, **kwargs):
        raise ConnectionError("no network: GLUE is not reachable")

    prev = sys.modules.get("datasets")
    sys.modules["datasets"] = types.SimpleNamespace(
        load_dataset=load_dataset)
    try:
        yield
    finally:
        if prev is None:
            sys.modules.pop("datasets", None)
        else:
            sys.modules["datasets"] = prev


def roberta_mnli_phase(argv=ROBERTA_ARGS) -> dict:
    """``train_dp --model roberta-large --task mnli`` at the recipe: the
    train phase's checks (counted with the pooler's pre-dropout, both
    splits' eval batches; finite losses; every parameter moved; a rerun
    bit-identical) at 2 steps; its samples/s, ms a step, peak memory and
    both accuracies printed."""
    with offline_datasets():
        res = train_phase(argv, tag="roberta-mnli", steps=2)
    keep = ("samples_per_s", "ms_per_step", "peak_mem_bytes", "accuracy",
            "accuracy_matched", "accuracy_mismatched")
    say("[roberta-mnli] " + json.dumps({k: res[k] for k in keep}))
    return res


def stream_run(impl: str, ln: str):
    """One counted roberta-large run of ``STREAM_TRAIN`` on MNLI under the
    stream ``impl`` and ``layernorm_impl`` ``ln``: (trainer, launches,
    wall seconds)."""
    from pytorch_distributed_training_tpu_torch.ops import _build
    from pytorch_distributed_training_tpu_torch.train.loop import Trainer
    from pytorch_distributed_training_tpu_torch.utils.config import (
        TrainConfig,
        model_preset,
    )

    mcfg = model_preset("roberta-large", dropout_impl=impl,
                        layernorm_impl=ln)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    with offline_datasets(), no_mask_tensor(f"dropout-streams {impl}"):
        trainer = Trainer(mcfg, TrainConfig(**STREAM_TRAIN), task="mnli",
                          device="cuda")
        trainer.run()
    return trainer, dict(_build.LAUNCH_COUNTS), time.perf_counter() - t0


def dropout_streams_phase(settings=STREAM_SETTINGS) -> dict:
    """roberta-large, 1 step and the eval, under each stream (fused
    LayerNorm) and under the reference LayerNorm: counted
    (``stream_launches``: no kernel 3 or 4 in the train step, the stream's
    mode of kernel 5, kernels 1 and 2 or none), finite losses, a rerun
    bit-equal for kernel 5's bits8 and exact modes; ms a step beside each
    other."""
    out = {}
    for impl, ln in settings:
        tag = f"{impl}/{ln}"
        trainer, counts, wall = stream_run(impl, ln)
        check_launches(f"dropout-streams {tag} run", counts, stream_launches(
            micro=trainer.state.step * trainer.tcfg.grad_accum_steps,
            eval_batches=eval_batches(trainer),
            layers=trainer.mcfg.num_layers, impl=impl, ln=ln))
        m = train_metrics(trainer, wall)
        del trainer
        _free_cuda()
        if m["steps"] != 1 or not all(
                map(math.isfinite, m["losses"] + m["grad_norms"])):
            raise AssertionError(f"dropout-streams {tag}: {m}")
        if impl in STREAM_RERUN:
            again, _, _ = stream_run(impl, ln)
            rerun = train_metrics(again, 0.0)["losses"]
            del again
            _free_cuda()
            if rerun != m["losses"]:
                raise AssertionError(
                    f"dropout-streams {tag}: the rerun's losses differ: "
                    f"{rerun} vs {m['losses']}")
        m["launches"] = counts
        out[impl if ln == "fused" else f"{impl}-{ln}-ln"] = m
        say(f"[dropout-streams] {tag}: "
            + ("losses bit-identical on a rerun; " if impl in STREAM_RERUN
               else "") + json.dumps(m))
    return out


def _summarize_metrics():
    """``scripts/summarize_metrics.py`` as a module, for its
    ``load_records`` (its ``summarize`` imports the JAX package's span
    helpers, which this script leaves alone; the CPU tests run it on the
    port's stream)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "summarize_metrics", os.path.join(ROOT, "scripts",
                                          "summarize_metrics.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def telemetry_faults_phase(root: str, plain: dict,
                           argv=ROBERTA_ARGS) -> dict:
    """The roberta-mnli run again with ``--metrics-dir``: its stream read
    back (``summarize_metrics.load_records``; run_meta, a step record a
    step with the device block, the epoch record with the straggler stats),
    ms a step beside ``plain``'s (the same run without telemetry); then
    the crash drill: the tiny preset under ``PDT_TPU_FAULT=
    crash_at_step:1`` and ``--max-restarts 1`` with a fresh
    ``--checkpoint-dir``, resumed in the same process, against the
    uninterrupted run: step 2's loss and every weight bit-equal."""
    from pytorch_distributed_training_tpu_torch.cli import train_dp
    from pytorch_distributed_training_tpu_torch.faults import inject

    mdir = os.path.join(root, "metrics")
    with offline_datasets():
        trainer, _, wall = train_once(argv + ["--metrics-dir", mdir])
    with_t = train_metrics(trainer, wall)
    del trainer
    _free_cuda()
    recs = _summarize_metrics().load_records(mdir)
    kinds = [r["record"] for r in recs]
    # the guards' audits and the warm start's compile record before the
    # first step (the default guards, record); no violation record
    if kinds != ["run_meta", "sharding_audit", "compile", "comm_audit",
                 "step", "step", "epoch"] or not all(
            r["device_block_s"] > 0 and not r["compile_inclusive"]
            for r in recs if r["record"] == "step") or not all(
            r["ok"] for r in recs if r["record"].endswith("_audit")):
        raise AssertionError(f"telemetry stream: {recs[:4]}")
    meta, epoch = recs[0], recs[-1]
    steps = [{k: r[k] for k in ("step", "data_wait_s", "dispatch_s",
                                "device_block_s", "step_s",
                                "compile_inclusive")}
             for r in recs if r["record"] == "step"]
    res = dict(ms_per_step=with_t["ms_per_step"],
               compile=next(r for r in recs if r["record"] == "compile"),
               ms_per_step_without=plain["ms_per_step"],
               ratio=with_t["ms_per_step"] / plain["ms_per_step"],
               losses_equal=with_t["losses"] == plain["losses"],
               steps=steps, device_name=meta["device_name"],
               straggler=epoch["straggler"])
    if not res["losses_equal"]:
        raise AssertionError(f"telemetry changed the losses: {with_t} vs "
                             f"{plain}")
    say("[telemetry-faults] roberta-mnli with --metrics-dir: "
        + json.dumps(res))
    base = train_dp.train(DRILL_ARGS + ["--checkpoint-dir",
                                        os.path.join(root, "base")])
    want = (weights_digest(base.state.module), base.step_log)
    del base
    drill_dir, drill_m = os.path.join(root, "drill"), os.path.join(root, "dm")
    os.environ[inject.ENV_VAR] = "crash_at_step:1"
    inject.set_plan(None)  # parsed from the environment at its first use
    try:
        t0 = time.perf_counter()
        t = train_dp.train(DRILL_ARGS + [
            "--checkpoint-dir", drill_dir, "--max-restarts", "1",
            "--metrics-dir", drill_m])
        drill_s = time.perf_counter() - t0
    finally:
        os.environ.pop(inject.ENV_VAR)
        inject.set_plan(None)
    kinds = [r["record"] for r in _summarize_metrics().load_records(drill_m)]
    restore = t.checkpointer.restores[-1]
    got = (weights_digest(t.state.module), t.step_log)
    if (got[0] != want[0] or restore["step"] != 1
            or got[1] != want[1][1:] or kinds.count("restart") != 1
            or kinds.count("run_meta") != 2):
        raise AssertionError(f"crash drill: restored {restore}, steps "
                             f"{got[1]} against {want[1]}, records {kinds}")
    drill = dict(seconds=drill_s, restore=restore, step2=got[1][0],
                 records=kinds)
    say("[telemetry-faults] crash_at_step:1 under --max-restarts 1: one "
        "restart, resumed from step 1, step 2's loss and every weight "
        "bit-equal to the uninterrupted run: " + json.dumps(drill))
    return dict(res, drill=drill)


def cpu_vs_card_phase(argv=TINY_ARGS, cli="train_dp",
                      rtol=CPU_CARD_RTOL) -> dict:
    """The tiny preset with dropout on, 2 steps of accumulation 2 from one
    seed, on the CPU (plain versions) and on the card (kernels; a
    classification run's launches counted), within ``rtol``."""
    metrics = lm_metrics if cli == "train_lm" else train_metrics
    runs = {}
    for device in ("cpu", "cuda"):
        trainer, counts, _ = train_once(argv + ["--device", device], cli)
        runs[device] = metrics(trainer, 0.0)
        if trainer.mcfg.hidden_dropout <= 0 or len(trainer.step_log) != 2:
            raise AssertionError("cpu-vs-card wants dropout on and 2 steps")
        if device == "cuda" and cli != "train_lm":
            check_launches(f"cpu-vs-card {cli} run", counts,
                           train_launches(trainer))
    cpu, card = runs["cpu"], runs["cuda"]
    for key in ("losses", "grad_norms"):
        for a, b in zip(cpu[key], card[key]):
            if not math.isclose(a, b, rel_tol=rtol):
                raise AssertionError(
                    f"cpu-vs-card {key}: cpu {cpu[key]} card {card[key]} "
                    f"(rtol {rtol})")
    res = dict(cpu_losses=cpu["losses"], card_losses=card["losses"],
               cpu_grad_norms=cpu["grad_norms"],
               card_grad_norms=card["grad_norms"],
               max_rel_diff=max(abs(a - b) / abs(a) for a, b in zip(
                   cpu["losses"] + cpu["grad_norms"],
                   card["losses"] + card["grad_norms"])), launches=counts)
    say(f"[cpu-vs-card] {trainer.mcfg.num_layers}-layer "
        f"{argv[argv.index('--model') + 1]} ({cli}), dropout on, float32: "
        + json.dumps(res) + f" (rtol {rtol})")
    return res


def stage_phase(argv=TINY_ARGS) -> dict:
    """``train_mp --mp-mode stage`` at world size 1 (one stage: BERT
    itself) against ``train_dp`` from the same seed on the card, dropout
    on: the same per-step losses and grad norms, bit for bit; then
    ``--mp-mode pipeline`` and ``--mp-mode 1f1b`` at micro 8 in 4
    pipeline microbatches against ``--mp-mode stage`` at micro 2, bit for
    bit."""
    card = argv + ["--device", "cuda"]
    stage = ["--mp-mode", "stage"]
    runs = {}
    for name, cli, extra in (
            ("stage", "train_mp", stage), ("train_dp", "train_dp", []),
            ("stage-micro-2", "train_mp", stage + ["--micro-batch-size", "2"]),
            *((mode, "train_mp", ["--mp-mode", mode,
                                  "--pipeline-microbatches", "4"])
              for mode in ("pipeline", "1f1b"))):
        trainer, _, _ = train_once(card + extra, cli)
        runs[name] = [(s["loss"], s["grad_norm"]) for s in trainer.step_log]
        del trainer
    for name, want in (("stage", "train_dp"), ("pipeline", "stage-micro-2"),
                       ("1f1b", "stage-micro-2")):
        if runs[name] != runs[want]:
            raise AssertionError(f"{name} {runs[name]} against {want} "
                                 f"{runs[want]}")
    say("[stage] train_mp --mp-mode stage at world 1 equals train_dp bit for "
        "bit: " + json.dumps(runs["stage"]) + "; --mp-mode pipeline and "
        "1f1b (4 pipeline microbatches of 2 rows) equal --mp-mode stage at "
        "micro 2 bit for bit: " + json.dumps(runs["pipeline"]))
    return runs


def train_pipeline_phase(argv=PIPELINE_ARGS) -> dict:
    """``train_mp`` at full width through the GPipe and 1F1B schedules and
    stage mode, at world size 1 (one stage: the schedules are
    microbatching), each run counted from the trainer's first step to its
    eval's end against the launches its microbatches derive (4x stage
    mode's under the schedules), with finite losses and every parameter
    moved; the peak memory of the train steps alone (reset before them,
    read before the eval), beside what the run holds at its start (its
    weights)."""
    import torch

    from pytorch_distributed_training_tpu_torch.cli import train_mp
    from pytorch_distributed_training_tpu_torch.ops import _build

    out = {}
    for mode in PIPELINE_MODES:
        trainer = train_mp.build_trainer(train_mp.build_parser().parse_args(
            argv + ["--mp-mode", mode]))
        peak, evaluate = {}, trainer.evaluate

        def train_peak_then_evaluate(evaluate=evaluate, peak=peak):
            torch.cuda.synchronize()
            peak["train"] = torch.cuda.max_memory_allocated()
            return evaluate()

        trainer.evaluate = train_peak_then_evaluate
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        _build.reset_launch_counts()
        with no_mask_tensor(f"train-pipeline {mode} run"):
            t0 = time.perf_counter()
            trainer.run()
            wall = time.perf_counter() - t0
        counts = dict(_build.LAUNCH_COUNTS)
        tc = trainer.tcfg
        micro = trainer.state.step * tc.grad_accum_steps * trainer.n_micro
        check_launches(
            f"train-pipeline {mode} run ({micro} microbatches of "
            f"{tc.micro_batch_size // trainer.n_micro} rows, "
            f"{trainer.eval_loader.steps_per_epoch} eval batches)", counts,
            train_launches(trainer))
        res = train_metrics(trainer, wall)
        if res["steps"] != 2 or not all(
                map(math.isfinite, res["losses"] + res["grad_norms"])):
            raise AssertionError(f"train-pipeline {mode}: {res}")
        start = initial_weights(trainer)
        now = trainer.state.module.state_dict()
        unmoved = [k for k in start if torch.equal(now[k].cpu(), start[k])]
        if unmoved:
            raise AssertionError(f"train-pipeline {mode}: parameters "
                                 f"unchanged: {unmoved[:5]}")
        res.update(mode=mode, n_micro=trainer.n_micro, microbatches=micro,
                   train_peak_mem_bytes=peak["train"],
                   resident_mem_bytes=resident,
                   pipeline_bubble=trainer.step_log[-1].get(
                       "pipeline_bubble"), launches=counts)
        # the next run's peak starts with nothing of this one's held
        del trainer, start, now, evaluate, train_peak_then_evaluate
        gc.collect()
        torch.cuda.empty_cache()
        say(f"[train-pipeline] {mode}: " + json.dumps(res))
        out[mode] = res
    if [out[m]["n_micro"] for m in PIPELINE_MODES] != [4, 4, 1]:
        raise AssertionError(f"train-pipeline: n_micro "
                             f"{[out[m]['n_micro'] for m in PIPELINE_MODES]}")
    return out


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


def flash_kernel_parity(device, shape, rate, seed) -> float:
    """Kernels 6 and 9 each against its plain version on the same inputs
    (bf16, causal, key-padding bias, site 2): the forward's o and lse, and
    the backward fed the plain forward's o and lse. ``flash_pair_parity``
    holds the chain instead, the backward fed the kernel's own o, whose bf16
    roundings move delta and, where they flip the bf16 rounding of a large
    ds, dq by a bf16 step of ds times k: at head dim 32 the chain can put a
    dq element past the tolerance that each kernel alone keeps."""
    import torch

    from pytorch_distributed_training_tpu_torch.ops import (
        flash_attention as fa,
    )

    (q, k, v, do), bias = flash_inputs(device, shape, torch.bfloat16,
                                       seed=seed)
    kw = dict(causal=True, rate=rate, seed=seed, site=2)
    o_p, lse_p = fa.reference_flash_fwd(q, k, v, bias, **kw)
    o_k, lse_k = fa.flash_fwd(q, k, v, bias, **kw)
    lerr = (lse_k - lse_p).abs()
    if bool((lerr > 1e-5 * lse_p.abs().clamp_min(1.0)).any()):
        raise AssertionError(f"flash_fwd lse {shape}: max err "
                             f"{float(lerr.max())}")
    what = f"flash {tuple(shape)} bf16 rate {rate}"
    worst = check_flash_close(what + " o", o_k, o_p)
    got = fa.flash_bwd(q, k, v, bias, o_p, lse_p, do, **kw)
    want = fa.reference_flash_bwd(q, k, v, bias, o_p, lse_p, do, **kw)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        worst = max(worst, check_flash_close(f"{what} {name}", a, b))
    return worst


def flash_whole_kernel_parity(device, shapes=FLASH_WHOLE_ALONE,
                              rate=DROPOUT_RATE, seed=13) -> float:
    """Kernels 7 and 8 each alone against its plain version (bf16, causal
    and not, key-padding bias; kernel 8 fed the plain forward's o) where
    the chain's shape does not take it: head_dim 32 and 16, three and four
    k-tiles, lengths off the 64-key tile and off a multiple of 4 (each
    lane draws its own mask bits), and scores wide enough for the exact
    divisions."""
    import torch

    from pytorch_distributed_training_tpu_torch.ops import (
        flash_attention as fa,
    )

    worst = 0.0
    for i, (shape, q_scale) in enumerate(shapes):
        (q, k, v, do), bias = flash_inputs(device, shape, torch.bfloat16,
                                           seed=seed + i)
        q = q * q_scale
        for causal in (True, False):
            kw = dict(causal=causal, rate=rate, seed=seed + i, site=2)
            what = (f"{list(shape)} q x {q_scale} causal {causal} rate "
                    f"{rate}")
            o = fa.reference_whole_fwd(q, k, v, bias, **kw)
            worst = max(worst, check_flash_close(
                f"flash_whole_fwd {what}",
                fa.flash_whole_fwd(q, k, v, bias, **kw), o))
            got = fa.flash_whole_bwd(q, k, v, bias, o, do, **kw)
            want = fa.reference_whole_bwd(q, k, v, bias, o, do, **kw)
            for name, a, b in zip(("dq", "dk", "dv"), got, want):
                worst = max(worst, check_flash_close(
                    f"flash_whole_bwd {what} {name}", a, b))
    return worst


def flash_mask_parity(device, shapes=FLASH_MASK_SHAPES,
                      whole_lengths=FLASH_WHOLE_MASK_LENGTHS,
                      dq_shapes=FLASH_DQ_MASK_SHAPES,
                      rate=DROPOUT_RATE, seed=5, site=3) -> None:
    """The tensor-core kernels 6-11 draw the plain version's mask bit for
    bit: q = 0 (every visible key weighs the same) and v (forward) or dO
    (backward) one-hot along head_dim, so o[b, n, i, j] and dv[b, n, j, i]
    are nonzero exactly where element (i, j) of the probs is kept. Kernels
    7 and 8 (Sq = Sk, keys or rows past head_dim too) take v, or dO, one-hot
    over one window of 64 keys, or q rows, at a time, the others zero.
    Kernel 10: o = 0 (so delta = 0), v and dO all ones (dP = D before the
    mask) and k one-hot over one window of 64 keys at a time, so dq[b, n,
    i, j] is nonzero exactly where element (i, k0 + j) is kept.
    Non-causal, [2, 3, Sq, 64] bf16, the bf16 tolerance cannot hide a
    flipped bit here."""
    import torch

    from pytorch_distributed_training_tpu_torch.ops import (
        flash_attention as fa,
    )

    b, n, d = 2, 3, 64
    eye = torch.eye(d, device=device, dtype=torch.bfloat16)
    g = torch.Generator(device=device).manual_seed(seed)
    kw = dict(causal=False, rate=rate, seed=seed, site=site)

    def check(what, got, want, sq, sk):
        if not torch.equal(got, want):
            raise AssertionError(
                f"{what} [{b}, {n}, {sq}, {sk}] rate {rate}: "
                f"{int((got != want).sum())} mask elements differ from the "
                f"plain version's")

    def windows(s):
        for w0 in range(0, s, d):
            yield w0, min(d, s - w0)

    for sq, sk in shapes:
        q = torch.zeros(b, n, sq, d, device=device, dtype=torch.bfloat16)
        k = torch.randn(b, n, sk, d, generator=g, device=device).to(
            torch.bfloat16)
        v = eye[:sk].expand(b, n, sk, d).contiguous()
        do = eye[:sq].expand(b, n, sq, d).contiguous()
        bias = torch.zeros(b, 1, 1, sk, device=device)
        keep = fa.probs_keep((b, n, sq, sk), rate, seed, site, device)
        o, lse = fa.flash_fwd(q, k, v, bias, **kw)
        _, _, dv = fa.flash_bwd(q, k, v, bias, o, lse, do, **kw)
        _, dv11 = fa.flash_dkv(q, k, v, bias, o, lse, do, **kw)
        check("flash_fwd o", o[..., :sk] != 0, keep, sq, sk)
        for what, grad in (("flash_bwd dv", dv), ("flash_dkv dv", dv11)):
            check(what, grad[..., :sq] != 0, keep.transpose(-1, -2), sq, sk)
    for s in whole_lengths:
        q = torch.zeros(b, n, s, d, device=device, dtype=torch.bfloat16)
        k = torch.randn(b, n, s, d, generator=g, device=device).to(
            torch.bfloat16)
        bias = torch.zeros(b, 1, 1, s, device=device)
        keep = fa.probs_keep((b, n, s, s), rate, seed, site, device)
        zeros = torch.zeros(b, n, s, d, device=device, dtype=torch.bfloat16)
        for w0, width in windows(s):
            one_hot = zeros.clone()
            one_hot[:, :, w0:w0 + width] = eye[:width]
            o = fa.flash_whole_fwd(q, k, one_hot, bias, **kw)
            check(f"flash_whole_fwd o (keys {w0}..{w0 + width - 1})",
                  o[..., :width] != 0, keep[..., w0:w0 + width], s, s)
            _, _, dv = fa.flash_whole_bwd(q, k, k, bias, zeros, one_hot,
                                          **kw)
            check(f"flash_whole_bwd dv (q rows {w0}..{w0 + width - 1})",
                  dv[..., :width] != 0,
                  keep[..., w0:w0 + width, :].transpose(-1, -2), s, s)
    for sq, sk in dq_shapes:
        q = torch.zeros(b, n, sq, d, device=device, dtype=torch.bfloat16)
        ones_k = torch.ones(b, n, sk, d, device=device, dtype=torch.bfloat16)
        bias = torch.zeros(b, 1, 1, sk, device=device)
        keep = fa.probs_keep((b, n, sq, sk), rate, seed, site, device)
        _, lse = fa.flash_fwd(q, ones_k, ones_k, bias, **kw)
        o = torch.zeros_like(q)
        do = torch.ones_like(q)
        for w0, width in windows(sk):
            k = torch.zeros_like(ones_k)
            k[:, :, w0:w0 + width] = eye[:width]
            dq = fa.flash_dq(q, k, ones_k, bias, o, lse, do, **kw)
            check(f"flash_dq dq (keys {w0}..{w0 + width - 1})",
                  dq[..., :width] != 0, keep[..., w0:w0 + width], sq, sk)
    say(f"[kernels] flash_fwd/flash_bwd/flash_dkv bf16 masks bit for bit: "
        f"(Sq, Sk) {list(shapes)}; flash_whole_fwd/flash_whole_bwd at Sq = "
        f"Sk in {list(whole_lengths)}; flash_dq at (Sq, Sk) "
        f"{list(dq_shapes)}; rate {rate}")


def kernel_ms_by_symbol(fn, reps=20) -> dict:
    """Device ms a call of each kernel ``fn`` launches, by symbol (template
    arguments dropped), from ``torch.profiler`` over ``reps`` eager
    calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for e in profile_averages(prof):
        if e.device_type != DeviceType.CUDA:
            continue
        m = re.search(r"(\w+)<", e.key) or re.search(r"(\w+)\(", e.key)
        name = m.group(1) if m else e.key
        us = float(getattr(e, "self_device_time_total", 0.0))
        out[name] = out.get(name, 0.0) + us / reps / 1e3
    return out


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
    main paths' shapes, the forwards also at rate 0."""
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
        if not whole:
            # the tensor-core path also at head_dim 32, and its masks
            worst = max(worst, flash_kernel_parity(
                device, FLASH_BLOCKWISE_D32, DROPOUT_RATE, 12))
            flash_mask_parity(device)
            extra = (f" (and {list(FLASH_BLOCKWISE_D32)} at rate "
                     f"{DROPOUT_RATE}, each kernel on the plain version's "
                     f"inputs)")
        else:
            worst = max(worst, flash_whole_kernel_parity(device))
            extra = (f" (and flash_whole_fwd, flash_whole_bwd each alone "
                     f"at {[list(x) for x, _ in FLASH_WHOLE_ALONE]}, the "
                     f"last with q x 16, causal and not, rate "
                     f"{DROPOUT_RATE})")
        worst32 = flash_pair_parity(device, shape, whole, torch.float32,
                                    DROPOUT_RATE, 20, uniform=True)
        say(f"[kernels] {names[0]}/{names[1]} parity ok: {list(shape)} "
            f"causal, ragged + fully masked rows; bf16 at rates 0 and "
            f"{DROPOUT_RATE}{extra}, max abs err {worst} (<= "
            f"{FLASH_BF16_ULPS} bf16 ulps + {FLASH_BF16_SLACK} x "
            f"max|want|); float32 at rate "
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
        # rate 0, like SDPA
        kw0 = dict(kw, rate=0.0)
        if whole:
            # and the backward's kernels one by one (the statistics
            # pre-pass, the main kernel, the dq sum)
            t_fwd["rate0_ms"] = time_ms(
                lambda: fa.flash_whole_fwd(q, k, v, bias, **kw0))
            o0 = fa.flash_whole_fwd(q, k, v, bias, **kw0)
            bwd0 = lambda: fa.flash_whole_bwd(  # noqa
                q, k, v, bias, o0, do, **kw0)
            t_bwd["rate0_ms"] = time_ms(bwd0)
            t_bwd["kernel_ms"] = kernel_ms_by_symbol(bwd)
            t_bwd["rate0_kernel_ms"] = kernel_ms_by_symbol(bwd0)
            del o0
        else:
            # and the backward's kernels one by one (the delta pre-pass,
            # the main kernel, the dq sum)
            o0, lse0 = fa.flash_fwd(q, k, v, bias, **kw0)
            t_fwd["rate0_ms"] = time_ms(
                lambda: fa.flash_fwd(q, k, v, bias, **kw0))
            bwd0 = lambda: fa.flash_bwd(  # noqa
                q, k, v, bias, o0, lse0, do, **kw0)
            t_bwd["rate0_ms"] = time_ms(bwd0)
            t_bwd["kernel_ms"] = kernel_ms_by_symbol(bwd)
            t_bwd["rate0_kernel_ms"] = kernel_ms_by_symbol(bwd0)
            del o0, lse0
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


def two_pass_phase(device, shape=FLASH_BLOCKWISE) -> dict:
    """Kernels 10 and 11 against their plain versions and against the
    fused kernel 9's gradients on the same inputs (o and lse from the plain
    forward): bf16 at rates 0 and 0.1 (and at head_dim 32), float32 at 0.1
    with uniform probs; in bf16, kernel 11's dk and dv equal kernel 9's bit
    for bit (the same sums in the same order: kernel 9 with its dq work
    compiled out); then kernel, plain and SDPA-backward times at rates 0.1
    and 0 (each call with its own delta pre-pass, as a caller without
    ``delta=`` gets), and each one's pre-pass and main kernel one by
    one."""
    import torch

    from pytorch_distributed_training_tpu_torch.ops import (
        flash_attention as fa,
    )

    worst = {"flash_dq": 0.0, "flash_dkv": 0.0}
    d32 = FLASH_BLOCKWISE_D32
    cases = [(shape, torch.bfloat16, 0.0, 40, False),
             (shape, torch.bfloat16, DROPOUT_RATE, 41, False),
             (d32, torch.bfloat16, DROPOUT_RATE, 43, False),
             (shape, torch.float32, DROPOUT_RATE, 42, True)]
    for shp, dtype, rate, seed, uniform in cases:
        (q, k, v, do), bias = flash_inputs(device, shp, dtype, seed=seed,
                                           uniform=uniform)
        kw = dict(causal=True, rate=rate, seed=seed, site=2)
        o, lse = fa.reference_flash_fwd(q, k, v, bias, **kw)
        args = (q, k, v, bias, o, lse, do)
        got = {"flash_dq": (fa.flash_dq(*args, **kw),),
               "flash_dkv": fa.flash_dkv(*args, **kw)}
        plain = {"flash_dq": (fa.reference_flash_dq(*args, **kw),),
                 "flash_dkv": fa.reference_flash_dkv(*args, **kw)}
        fused = fa.flash_bwd(*args, **kw)
        fused = {"flash_dq": fused[:1], "flash_dkv": fused[1:]}
        tol = FLASH_FP32_TOL if dtype == torch.float32 else None
        for name in got:
            for grad, a, b, c in zip(("dq",) if name == "flash_dq"
                                     else ("dk", "dv"), got[name],
                                     plain[name], fused[name]):
                scale = 1.0 if tol is None else max(1.0,
                                                    float(b.abs().max()))
                lim = None if tol is None else tol * scale
                what = f"{name} {list(shp)} {dtype} rate {rate} {grad}"
                worst[name] = max(
                    worst[name], check_flash_close(what, a, b, tol=lim),
                    check_flash_close(what + " vs flash_bwd", a, c, tol=lim))
                if (name == "flash_dkv" and dtype == torch.bfloat16
                        and not torch.equal(a, c)):
                    raise AssertionError(
                        f"{what}: {int((a != c).sum())} elements differ "
                        f"from flash_bwd's (want bit for bit)")
    say(f"[kernels] flash_dq/flash_dkv parity ok: {list(shape)} causal, "
        f"ragged + fully masked rows; bf16 at rates 0 and {DROPOUT_RATE} "
        f"(and {list(d32)} at {DROPOUT_RATE}), float32 at {DROPOUT_RATE} "
        f"with uniform probs; against the plain halves and the fused "
        f"flash_bwd: max err {json.dumps(worst)} (bf16 <= {FLASH_BF16_ULPS} "
        f"ulps + {FLASH_BF16_SLACK} x max|want|, float32 <= "
        f"{FLASH_FP32_TOL} x max(1, max|want|)); bf16 flash_dkv dk, dv "
        f"equal to flash_bwd's bit for bit")

    (q, k, v, do), bias = flash_inputs(device, shape, torch.bfloat16,
                                       seed=30)
    kw = dict(causal=True, rate=DROPOUT_RATE, seed=30, site=2)
    kw0 = dict(kw, rate=0.0)
    o, lse = fa.flash_fwd(q, k, v, bias, **kw)
    o0, lse0 = fa.flash_fwd(q, k, v, bias, **kw0)
    args = (q, k, v, bias, o, lse, do)
    args0 = (q, k, v, bias, o0, lse0, do)
    qc, kc, vc, doc = (t.contiguous() for t in (q, k, v, do))
    lib = torch.ops.aten._scaled_dot_product_flash_attention(
        qc, kc, vc, 0.0, True)
    sdpa_bwd = lambda: (  # noqa
        torch.ops.aten._scaled_dot_product_flash_attention_backward(
            doc, qc, kc, vc, lib[0], lib[1], lib[2], lib[3], lib[4], lib[5],
            0.0, True, lib[6], lib[7]))
    b, n, sl, d = shape
    x = b * n * sl * d * 2
    pairs = b * n * sl * (sl + 1) // 2
    extra = b * n * sl * 4 + b * sl * 4              # lse, bias
    bounds = {"flash_dq": bound(6 * x + extra, 6.0 * d * pairs,
                                BF16_FLOPS_PER_S),
              "flash_dkv": bound(7 * x + extra, 8.0 * d * pairs,
                                 BF16_FLOPS_PER_S)}
    fns = {"flash_dq": (fa.flash_dq, fa.reference_flash_dq),
           "flash_dkv": (fa.flash_dkv, fa.reference_flash_dkv)}
    plain_kw = dict(reps=5, inner=2)
    res = {}
    for name, (kern, ref) in fns.items():
        t = dict(ms=time_ms(lambda: kern(*args, **kw)),
                 rate0_ms=time_ms(lambda: kern(*args0, **kw0)),
                 plain_ms=time_ms(lambda: ref(*args, **kw), **plain_kw),
                 library_ms=time_ms(sdpa_bwd))
        t["bound_ms"], t["bound_by"] = bounds[name]
        # the delta pre-pass and the main kernel
        t["kernel_ms"] = kernel_ms_by_symbol(lambda: kern(*args, **kw))
        t["rate0_kernel_ms"] = kernel_ms_by_symbol(
            lambda: kern(*args0, **kw0))
        say(f"[kernels] {name} {list(shape)} bf16 causal rate {DROPOUT_RATE}: "
            + json.dumps(t) + " (library: the whole SDPA flash backward, "
              "rate 0, no bias)")
        res[name] = dict(max_abs_err=worst[name], **t)
    del q, k, v, do, o, o0, lib
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ----------------------------------------------------------------- phase 6


def expected_lm_launches(*, micro: int, eval_batches: int, layers: int,
                         whole: bool, two_pass: bool = False,
                         remat: bool = False) -> dict:
    """Launches of a counted LM run: per microbatch forward the LNs (2 a
    block + ln_f), the hidden dropouts (embeddings + 2 a block) and one
    flash forward a block; per backward the LN, dropout (the mask drawn
    again) and flash backwards (``two_pass``: flash_dq and flash_dkv for
    flash_bwd); per eval batch the forwards, deterministic. ``remat``
    (per-layer remat, any policy): each block's forward runs again in the
    backward up to its last tensor the backward needs (``mlp_down``'s
    input), so per microbatch 2 LNs, the attention output's dropout and
    the flash forward a block more. ``--remat-mlp`` adds none of these
    (its recompute stops at ``mlp_down``)."""
    fwd, bwd = (("flash_whole_fwd", "flash_whole_bwd") if whole
                else ("flash_fwd", "flash_bwd"))
    lns = 2 * layers + 1
    again = layers * micro if remat else 0
    out = {
        fwd: layers * (micro + eval_batches) + again,
        "layer_norm": lns * (micro + eval_batches) + 2 * again,
        "layer_norm_bwd": lns * micro,
        "mask_scale_apply": 2 * lns * micro + again,
    }
    for name in (("flash_dq", "flash_dkv") if two_pass else (bwd,)):
        out[name] = layers * micro
    return out


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
    with no_mask_tensor(f"{tag} run"):
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


def remat_run(what: str, argv) -> dict:
    """One counted ``train_lm`` run of ``argv``: its metrics, launches
    (checked against ``expected_lm_launches`` with the recomputed
    forwards of ``--remat``) and the peak memory of its train steps alone:
    reset after the trainer is built, read before its eval."""
    import torch

    from pytorch_distributed_training_tpu_torch.cli import train_lm
    from pytorch_distributed_training_tpu_torch.ops import _build

    trainer = train_lm.build_trainer(train_lm.build_parser().parse_args(argv))
    evaluate, peak = trainer.evaluate, {}

    def evaluate_after_peak():
        torch.cuda.synchronize()
        peak["train"] = torch.cuda.max_memory_allocated()
        return evaluate()

    trainer.evaluate = evaluate_after_peak
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    with no_mask_tensor(f"{what} run"):
        trainer.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_build.LAUNCH_COUNTS)
    tc, mc = trainer.tcfg, trainer.mcfg
    check_launches(f"{what} run ({trainer.state.step} steps)", counts,
                   expected_lm_launches(
                       micro=trainer.state.step * tc.grad_accum_steps,
                       eval_batches=trainer.eval_loader.steps_per_epoch,
                       layers=mc.num_layers, whole=False, remat=mc.remat))
    m = lm_metrics(trainer, wall)
    m.update(train_peak_bytes=peak["train"], micro=tc.micro_batch_size,
             remat=mc.remat, remat_policy=mc.remat_policy,
             remat_mlp=mc.remat_mlp, launches=counts)
    if m["steps"] != 2 or not all(map(math.isfinite,
                                      m["losses"] + m["grad_norms"])):
        raise AssertionError(f"{what}: {m}")
    del trainer
    _free_cuda()
    return m


def remat_phase(argv=REMAT_ARGS, settings=REMAT_SETTINGS) -> dict:
    """``train_lm`` at lm-1024's shape under each remat setting, 2 steps
    each, counted (the recomputed forwards included): the ms a step and
    the train steps' peak memory beside no remat's; the losses bit-equal
    to no remat's (the forward does not change) and the grad norms within
    TWO_PASS_RTOL (whether bit-equal printed)."""
    runs = {name: remat_run(f"remat {name}", argv + flags)
            for name, flags in settings}
    base = runs["none"]
    for name, m in runs.items():
        if m["losses"] != base["losses"] or not all(
                math.isclose(a, b, rel_tol=TWO_PASS_RTOL)
                for a, b in zip(m["grad_norms"], base["grad_norms"])):
            raise AssertionError(
                f"remat {name}: losses {m['losses']}, grad norms "
                f"{m['grad_norms']} against no remat's {base['losses']}, "
                f"{base['grad_norms']} (rtol {TWO_PASS_RTOL})")
        m.update(grad_norms_bit_equal=m["grad_norms"] == base["grad_norms"],
                 ms_per_step_vs_none=m["ms_per_step"] / base["ms_per_step"],
                 train_peak_vs_none=(m["train_peak_bytes"]
                                     / base["train_peak_bytes"]))
        say(f"[remat] {name}, micro {m['micro']}: " + json.dumps(m))
    return dict(micro4=runs)


def two_pass_lm_phase(fused, argv=LM_1024_ARGS, tag="lm-1024-two-pass"):
    """``train_lm`` on the lm-1024 run with ``PDT_FLASH_TWO_PASS=1``:
    kernels 10 and 11 take every blockwise backward (kernel 9 none), step
    1's loss equals the fused run's bit for bit, later steps within
    TWO_PASS_RTOL."""
    os.environ["PDT_FLASH_TWO_PASS"] = "1"
    try:
        trainer, counts, wall = train_once(argv, "train_lm")
    finally:
        del os.environ["PDT_FLASH_TWO_PASS"]
    tc, mc = trainer.tcfg, trainer.mcfg
    micro = trainer.state.step * tc.grad_accum_steps
    check_launches(
        f"{tag} run ({trainer.state.step} steps x {tc.grad_accum_steps} "
        f"microbatches)", counts, expected_lm_launches(
            micro=micro, eval_batches=trainer.eval_loader.steps_per_epoch,
            layers=mc.num_layers, whole=False, two_pass=True),
    )
    m = lm_metrics(trainer, wall)
    del trainer
    gc.collect()
    losses, ref = m["losses"], fused["losses"]
    if len(losses) != len(ref) or losses[0] != ref[0] or any(
            not math.isclose(a, b, rel_tol=TWO_PASS_RTOL)
            for a, b in zip(losses[1:], ref[1:])):
        raise AssertionError(f"{tag}: losses {losses} against the fused "
                             f"run's {ref} (step 1 exact, then rtol "
                             f"{TWO_PASS_RTOL})")
    m.update(launches=counts, fused_losses=ref,
             fused_ms_per_step=fused["ms_per_step"],
             fused_warm_ms_per_step=fused["warm"]["ms_per_step"])
    say(f"[{tag}] " + json.dumps(m))
    return m


def lm_scan_equal_phase(argv=TINY_LM_ARGS) -> dict:
    """``train_lm`` on the tiny LM with dropout on, on the card, with the
    scanned trunk (the default) and ``--no-scan-layers``: the per-step
    losses bit for bit, the grad norms and the weights within SCAN_RTOL,
    the same launches."""
    import numpy as np

    from pytorch_distributed_training_tpu_torch.models.convert import (
        params_to_jax,
    )

    runs = {}
    for flag in ("--scan-layers", "--no-scan-layers"):
        trainer, counts, _ = train_once(argv + ["--device", "cuda", flag],
                                        "train_lm")
        if trainer.mcfg.scan_layers != (flag == "--scan-layers"):
            raise AssertionError(f"lm-scan-equal: {flag} not taken")
        runs[flag] = (trainer.step_log, counts, params_to_jax(
            trainer.state.module.state_dict(), scan_layers=False))
        del trainer
    (scan, scan_counts, scan_w), (loop, loop_counts, loop_w) = (
        runs["--scan-layers"], runs["--no-scan-layers"])
    if [s["loss"] for s in scan] != [s["loss"] for s in loop]:
        raise AssertionError(f"lm-scan-equal: losses {scan} against {loop}")
    if scan_counts != loop_counts:
        raise AssertionError(f"lm-scan-equal: launches {scan_counts} "
                             f"against {loop_counts}")
    worst = {"grad_norm": max(abs(a["grad_norm"] - b["grad_norm"])
                              / abs(b["grad_norm"])
                              for a, b in zip(scan, loop))}

    def leaves(tree, path=()):
        for k, v in tree.items():
            yield from (leaves(v, path + (k,)) if isinstance(v, dict)
                        else [(path + (k,), v)])

    want = dict(leaves(loop_w))
    weight_rel = 0.0
    for path, got in leaves(scan_w):
        ref = want[path]
        np.testing.assert_allclose(got, ref, rtol=SCAN_RTOL, atol=0,
                                   err_msg="/".join(path))
        nz = ref != 0
        if nz.any():
            weight_rel = max(weight_rel, float(np.max(
                np.abs(got[nz] - ref[nz]) / np.abs(ref[nz]))))
    worst["weights"] = weight_rel
    if worst["grad_norm"] > SCAN_RTOL:
        raise AssertionError(f"lm-scan-equal: grad norms {scan} against "
                             f"{loop} (rtol {SCAN_RTOL})")
    res = dict(losses=[s["loss"] for s in scan],
               grad_norms=[s["grad_norm"] for s in scan],
               unscanned_grad_norms=[s["grad_norm"] for s in loop],
               max_rel_diff=worst, launches=scan_counts)
    say("[lm-scan-equal] scanned and unscanned tiny LM on the card, dropout "
        "on: losses bit for bit, launches equal: " + json.dumps(res)
        + f" (rtol {SCAN_RTOL})")
    return res


def _sharded_lm_trainer(argv):
    """``train_lm``'s trainer of ``argv``, then sharded with FSDP on a
    one-rank device mesh by the placements of an fsdp axis of
    LM_FSDP_SIZE."""
    from pytorch_distributed_training_tpu_torch.cli import train_lm
    from pytorch_distributed_training_tpu_torch.comms.mesh import (
        fsdp_device_mesh,
    )
    from pytorch_distributed_training_tpu_torch.parallel import (
        ShardingPolicy,
        param_placements,
    )

    trainer = train_lm.build_trainer(train_lm.build_parser().parse_args(argv))
    placements = param_placements(
        {n: tuple(p.shape) for n, p in trainer.state.module.named_parameters()},
        ShardingPolicy(fsdp=True), dict(trainer.mesh.shape, fsdp=LM_FSDP_SIZE))
    trainer.shard(placements, fsdp_device_mesh(trainer.mesh, "cuda"))
    return trainer, placements


# FSDP2's ranges that hold its device work (the all-gather with its
# copy-in and copy-out, the reduce-scatter); the others nest in these or
# hold none
_FSDP_WORK = re.compile(r"FSDP::(pre_forward|pre_backward|post_backward_"
                        r"reduce)")


def collective_time(averages) -> dict:
    """Calls and device ms of FSDP2's ranges (``FSDP::*``) and of the
    collectives (``c10d::*`` ops and the ``nccl:*``/``gloo:*`` ranges
    inside them, with the device work each launched) of a
    ``torch.profiler`` run's ``profile_averages``; ``fsdp_ms``: the ranges that hold FSDP's
    device work, ``collectives_ms``: the ``c10d::*`` ops'."""
    from torch.autograd import DeviceType

    ops = {}
    for e in averages:
        if e.device_type == DeviceType.CPU and e.key.startswith(
                ("nccl:", "gloo:", "c10d::", "FSDP::")):
            ops[e.key] = dict(calls=e.count, device_ms=float(getattr(
                e, "device_time_total", 0.0)) / 1e3)
    return dict(
        ops=ops,
        fsdp_ms=sum(v["device_ms"] for k, v in ops.items()
                    if _FSDP_WORK.match(k)),
        collectives_ms=sum(v["device_ms"] for k, v in ops.items()
                           if k.startswith("c10d::")))


def fsdp_checkpoint_check(trainer) -> dict:
    """Save the sharded trainer's state (every DTensor shard written),
    then restore it into an unwrapped ``train_lm`` trainer of the same
    run: every weight, moment, ``count``, ``step`` and ``dropout_seed``
    bit-equal."""
    import torch
    from torch.distributed.fsdp import FSDPModule

    from pytorch_distributed_training_tpu_torch.train import checkpoint

    def whole(state):
        return {k: (v.full_tensor() if hasattr(v, "full_tensor") else v)
                .detach().cpu().clone()
                for k, v in checkpoint._saveable(state).items()}

    root = tempfile.mkdtemp(prefix="pdt_lm_fsdp_")
    try:
        saver = checkpoint.Checkpointer(root)
        saver.save(trainer.state)
        want = whole(trainer.state)
        saver.wait()  # the asynchronous save commits and seals at the join
        sharded = sum(hasattr(v, "full_tensor") for v in
                      checkpoint._saveable(trainer.state).values())
        plain = _lm_trainer(LM_FSDP_ARGS + ["--checkpoint-dir", root,
                                            "--resume"])
        got = whole(plain.state)
        restore = plain.checkpointer.restores[-1]
        if isinstance(plain.state.model, FSDPModule) or sorted(got) != sorted(
                want) or any(not torch.equal(got[k], want[k]) for k in want):
            raise AssertionError("lm-fsdp: the unwrapped restore differs "
                                 "from the sharded save")
        del plain, got, want
        _free_cuda()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return dict(save=saver.saves[0], restore=restore,
                sharded_tensors=sharded)


def lm_fsdp_child(port: int) -> dict:
    """The lm-fsdp phase's process: a one-process NCCL group, then the
    LM_FSDP_ARGS run unwrapped (the losses' reference), the same run
    sharded (``_sharded_lm_trainer``) and counted, and the sharded run's
    first step and eval under ``torch.profiler``."""
    import torch
    import torch.distributed as dist
    from torch.distributed.fsdp import FSDPModule
    from torch.distributed.tensor import DTensor, Shard
    from torch.profiler import ProfilerActivity, profile

    from pytorch_distributed_training_tpu_torch.cli import train_lm
    from pytorch_distributed_training_tpu_torch.ops import _build

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        def run(trainer):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            trainer.run()
            torch.cuda.synchronize()
            m = lm_metrics(trainer, time.perf_counter() - t0)
            m.update(peak_mem_bytes=torch.cuda.max_memory_allocated(),
                     launches=dict(_build.LAUNCH_COUNTS))
            return m

        plain = run(train_lm.build_trainer(
            train_lm.build_parser().parse_args(LM_FSDP_ARGS)))
        gc.collect()
        torch.cuda.empty_cache()
        trainer, placements = _sharded_lm_trainer(LM_FSDP_ARGS)
        module = trainer.state.module
        sharded = [n for n, p in module.named_parameters()
                   if isinstance(p, DTensor)]
        if not isinstance(trainer.state.model, FSDPModule) or sorted(
                sharded) != sorted(n for n, pl in placements.items()
                                   if isinstance(pl, Shard)):
            raise AssertionError(f"lm-fsdp: not sharded as placed: "
                                 f"{sharded[:5]}")
        tc, mc = trainer.tcfg, trainer.mcfg
        fsdp = run(trainer)
        # the sharding audit after shard(), the first step's collective
        # audit (one rank: nothing crosses), under the default guards
        audits = dict(sharding=trainer.sharding_record,
                      comm=trainer.comm_record,
                      compile=trainer.compile_record)
        if not (audits["sharding"]["ok"] and audits["comm"]["ok"]
                and audits["compile"] is not None):
            raise AssertionError(f"lm-fsdp: audits {audits}")
        check_launches(
            f"lm-fsdp run ({trainer.state.step} steps)", fsdp["launches"],
            expected_lm_launches(
                micro=trainer.state.step * tc.grad_accum_steps,
                eval_batches=trainer.eval_loader.steps_per_epoch,
                layers=mc.num_layers, whole=False))
        if trainer.state.step != 2 or not mc.scan_layers:
            raise AssertionError(f"lm-fsdp: {trainer.state.step} steps, "
                                 f"scan_layers {mc.scan_layers}")
        ckpt_res = fsdp_checkpoint_check(trainer)
        del trainer, module
        gc.collect()
        torch.cuda.empty_cache()
        for key in ("losses", "grad_norms"):
            for a, b in zip(plain[key], fsdp[key]):
                if not math.isclose(a, b, rel_tol=CPU_CARD_RTOL):
                    raise AssertionError(
                        f"lm-fsdp {key}: unwrapped {plain[key]} sharded "
                        f"{fsdp[key]} (rtol {CPU_CARD_RTOL})")
        # the profile: one step + the eval, as lm-1024's
        trainer, _ = _sharded_lm_trainer(
            one_step(LM_FSDP_ARGS, LM_PROFILE_TRAIN_SIZE))
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            trainer.run()
        wall = time.perf_counter() - t0
        del trainer
        averages = profile_averages(prof)
        prof_res = device_time_by_class(averages, wall)
        collectives = collective_time(averages)
    finally:
        dist.destroy_process_group()
    if not any(k.startswith("FSDP::") for k in collectives["ops"]):
        raise AssertionError(f"lm-fsdp: no FSDP range in the profile: "
                             f"{collectives}")
    return dict(
        plain=plain, fsdp=fsdp, fsdp_size=LM_FSDP_SIZE, checkpoint=ckpt_res,
        audits=audits,
        sharded_params=len(sharded), params=len(placements),
        max_rel_diff=max(abs(a - b) / abs(a) for a, b in zip(
            plain["losses"] + plain["grad_norms"],
            fsdp["losses"] + fsdp["grad_norms"])),
        profile=dict(prof_res, profiled_wall_s=wall), **collectives)


def lm_fsdp_start():
    """Start ``lm_fsdp_child`` in a process of its own (the NCCL group
    stays out of this one); ``lm_fsdp_phase`` reads it. The mp-cp phase
    runs beside it (its tiny models and gloo pair leave the card and the
    host's cores mostly to this one)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    code = (f"import json, sys; sys.path.insert(0, {ROOT!r}); "
            f"import chip_smoke; "
            f"print('LM_FSDP ' + json.dumps(chip_smoke.lm_fsdp_child({port})))")
    return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def lm_fsdp_phase(proc) -> dict:
    """FSDP on the card: the lm-fsdp process (``lm_fsdp_start``); its
    lines relayed, its result read back."""
    try:
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    result = None
    for line in stdout.splitlines():
        if line.startswith("LM_FSDP "):
            result = json.loads(line[len("LM_FSDP "):])
        else:
            say(f"[lm-fsdp] {line}")
    if proc.returncode != 0 or result is None:
        raise AssertionError(f"lm-fsdp: exit {proc.returncode}: "
                             f"{stderr[-3000:]}")
    result["profile"].pop("port_us_per_launch", None)
    say("[lm-fsdp] gpt2-medium at seq 1024, 2 steps + eval, sharded by the "
        f"fsdp-{LM_FSDP_SIZE} placements on a one-rank device mesh against "
        "unwrapped: " + json.dumps(result) + f" (rtol {CPU_CARD_RTOL})")
    return result


# tp-split: one gpt2-medium block at lm-1024's shape (micro 4 x seq 1024),
# bf16, flash, probs dropout off (the flash kernels draw by the global
# head, which a slice renumbers) and hidden dropout at the preset's 0.1;
# each slice's bf16 partials are rounded before their sum, so the errors,
# max |got - want| over max |want| a tensor, stay within a few bf16 ulps
TP_SPLIT_SIZES = (2, 4)
TP_SPLIT_ROWS = (4, 1024)
TP_SPLIT_TOL = 3e-2
# ring: lm-1024's attention, [micro 4, seq 1024, 16 heads, head_dim 64],
# bf16, causal, against the plain reference on the card (the probabilities
# rounded to bf16 against another running max: a few bf16 ulps of the
# largest magnitude); the keep share of rate 0.1 on float32 uniform scores
RING_SHAPE = (4, 1024, 16, 64)
RING_SHARDS = (2, 4)
RING_TOL = 2e-2
RING_RATE = 0.1
RING_KEEP_SHAPE = (2, 1024, 16, 64)


def rel_err(got, want) -> float:
    """max |got - want| over max |want|, in float32."""
    want = want.float()
    return float((got.float() - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


def call_ms(fn) -> dict:
    """ms of ``fn`` called back to back (CUDA events around eager calls,
    the host's launches included) and device ms a call (the kernels'
    sum, ``torch.profiler``; None when the profile caught no kernel)."""
    device = sum(kernel_ms_by_symbol(fn, reps=3).values())
    # a profile that caught no kernel is no measurement
    return dict(ms=eager_ms(fn, reps=10, inner=3), device_ms=device or None)


def tp_split_check(cfg, m: int, *, device, batch: int, seq: int,
                   tol: float, timed: bool = True, seed: int = 0) -> dict:
    """One GPT-2 block of ``cfg``, whole and cut into ``m`` model-axis
    slices (``tensor_parallel`` with an in-process ``AxisShard``: no
    group, so each slice's collectives are the identity): each slice runs
    its attention on its heads and its MLP on its columns, the row-parallel
    partials summed here as the all-reduce sums them (the replicated biases
    on slice 0 alone, added once), the LayerNorms and dropouts once;
    output, input gradient and every weight gradient (the slices
    re-assembled on their split dims) against the whole block's, within
    ``tol``. ``timed``: a slice's forward + backward and the whole
    block's, ms a call back to back (CUDA events) and device ms a call
    (``torch.profiler``, the kernels' sum)."""
    import copy

    import torch
    import torch.nn.functional as F

    from pytorch_distributed_training_tpu_torch.comms.mesh import (
        AXIS_NAMES,
        AxisShard,
    )
    from pytorch_distributed_training_tpu_torch.models.bert import (
        _SITE_ATTENTION_NORM,
        _SITE_MLP_NORM,
        compute_dtype,
    )
    from pytorch_distributed_training_tpu_torch.models.gpt2 import GPT2Block
    from pytorch_distributed_training_tpu_torch.parallel.sharding import (
        ShardingPolicy,
        model_dims,
        param_specs,
        tensor_parallel,
    )

    gen = torch.Generator().manual_seed(seed)
    whole = GPT2Block(cfg, generator=gen)
    with torch.no_grad():  # biases off zero: the replicated ones count
        for name, p in whole.named_parameters():
            if name.endswith("bias"):
                p.normal_(0.0, 0.02, generator=gen)
    specs = param_specs(
        {n: tuple(p.shape) for n, p in whole.named_parameters()},
        ShardingPolicy(tp=True), {a: m if a == "model" else 1
                                  for a in AXIS_NAMES})
    dims = model_dims(specs)
    slices = []
    for r in range(m):
        part = copy.deepcopy(whole)
        shard = AxisShard(group=None, index=r, size=m,
                          ranks=tuple(range(m)))
        tensor_parallel(part, specs, shard)
        if not part.tp_shard is part.attention.tp_shard is shard:
            raise AssertionError("tp-split: the model axis not handed to "
                                 "the block's attention and MLP")
        if r:
            with torch.no_grad():
                part.attention.out.bias.zero_()
                part.mlp_down.bias.zero_()
        slices.append(part.to(device))
    whole = whole.to(device)
    dtype = compute_dtype(cfg)
    shape = (batch, seq, cfg.hidden_size)
    x = torch.randn(shape, generator=gen).to(device, dtype).requires_grad_()
    dy = torch.randn(shape, generator=gen).to(device, dtype)
    layer_seed = 1234

    def split_forward(x):
        first = slices[0]
        a = first.ln_1(x)
        h = sum(s.attention(a, None, dropout_seed=layer_seed)
                for s in slices)
        x = x + first.dropout(h, layer_seed, _SITE_ATTENTION_NORM)
        c = first.ln_2(x)
        h = sum(s.mlp_down(F.gelu(s.mlp_up(c), approximate="tanh"))
                for s in slices)
        return x + first.dropout(h, layer_seed, _SITE_MLP_NORM)

    def run(forward):
        x.grad = None
        y = forward(x)
        y.backward(dy)
        return y.detach(), x.grad.detach()

    want_y, want_dx = run(lambda x: whole(x, None, dropout_seed=layer_seed))
    got_y, got_dx = run(split_forward)
    params = [dict(s.named_parameters()) for s in slices]
    wants = dict(whole.named_parameters())
    errors = {"out": rel_err(got_y, want_y), "dx": rel_err(got_dx, want_dx)}
    for name, p in wants.items():
        got = (torch.cat([q[name].grad for q in params], dims[name])
               if name in dims else params[0][name].grad)
        if name.endswith("key.bias"):
            # zero but for rounding (it shifts a row's scores alike): its
            # error is taken at the query bias's scale
            scale = wants[name.replace("key", "query")].grad
            errors[name] = float((got - p.grad).float().abs().max()
                                 / scale.float().abs().max())
        else:
            errors[name] = rel_err(got, p.grad)
    worst = max(errors.values())
    if not (torch.isfinite(got_y).all() and worst <= tol):
        raise AssertionError(f"tp-split: model {m}: errors {errors} (tol "
                             f"{tol})")
    res = dict(model=m, heads=cfg.num_heads // m,
               mlp_columns=cfg.intermediate_size // m, max_rel_err=worst,
               out_err=errors["out"], dx_err=errors["dx"],
               leaves=len(errors) - 2)
    if timed:
        one = slices[0]
        for net, key in ((one, "slice"), (whole, "whole")):
            def step(net=net):
                net(x, None, dropout_seed=layer_seed).backward(dy)

            res[f"{key}_ms"] = eager_ms(step, reps=10, inner=5)
            res[f"{key}_device_ms"] = sum(kernel_ms_by_symbol(
                step, reps=5).values()) or None
    return res


def tp_split_phase(device, sizes=TP_SPLIT_SIZES, rows=TP_SPLIT_ROWS) -> list:
    """``tp_split_check`` on one gpt2-medium block (bf16, flash) at each
    model-axis size of ``sizes``."""
    from pytorch_distributed_training_tpu_torch.utils.config import (
        model_preset,
    )

    cfg = model_preset("gpt2-medium", attention_dropout=0.0)
    out = []
    for m in sizes:
        res = tp_split_check(cfg, m, device=device, batch=rows[0],
                             seq=rows[1], tol=TP_SPLIT_TOL)
        say(f"[tp-split] gpt2-medium block at [{rows[0]}, {rows[1]}], bf16, "
            f"flash, cut into {m} model-axis slices ({res['heads']} heads, "
            f"{res['mlp_columns']} MLP columns a slice), partials summed in "
            f"this process, against the whole block: " + json.dumps(res)
            + f" (tol {TP_SPLIT_TOL})")
        out.append(res)
    return out


def ring_phase(device, shape=RING_SHAPE, shards=RING_SHARDS,
               tol=RING_TOL, keep_shape=RING_KEEP_SHAPE,
               timed: bool = True) -> dict:
    """Ring attention on the card, the sequence of ``shape`` (bf16,
    causal) cut into each count of ``shards`` shards driven in turn in
    this process (``ops/ring_attention.ring_attention``): forward and
    q/k/v gradients against ``reference_attention`` within ``tol``; rate
    RING_RATE finite, alike twice, and keeping 1 - rate of the
    probabilities within 1% (float32 q = k = 0, v = 1 at ``keep_shape``,
    not causal: each output is the kept share / (1 - rate)); ``timed``:
    ms of forward + backward (``call_ms``) beside reference attention's
    and kernels 6 + 9's (``flash_attention``, rate 0: its eager call, and
    the kernels alone by CUDA graph replay), for the record."""
    import torch

    from pytorch_distributed_training_tpu_torch.ops import (
        flash_attention as fa,
    )
    from pytorch_distributed_training_tpu_torch.ops.attention import (
        reference_attention,
    )
    from pytorch_distributed_training_tpu_torch.ops.ring_attention import (
        ring_attention,
    )

    gen = torch.Generator().manual_seed(0)
    q, k, v, dy = (torch.randn(shape, generator=gen).to(device,
                                                        torch.bfloat16)
                   for _ in range(4))

    def fwd_bwd(fn):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves)
        out.backward(dy)
        return out.detach(), [t.grad for t in leaves]

    def ring(n):
        return lambda q, k, v: ring_attention(q, k, v, n_shards=n,
                                              causal=True)

    def reference(q, k, v):
        return reference_attention(q, k, v, causal=True)

    want, want_g = fwd_bwd(reference)
    res = {}
    for n in shards:
        out, grads = fwd_bwd(ring(n))
        errors = {"out": rel_err(out, want), **{
            f"d{name}": rel_err(g, w)
            for name, g, w in zip("qkv", grads, want_g)}}
        if not (torch.isfinite(out).all() and max(errors.values()) <= tol):
            raise AssertionError(f"ring: {n} shards: errors {errors} (tol "
                                 f"{tol})")
        res[f"shards_{n}"] = dict(errors)
        if timed:
            res[f"shards_{n}"].update(call_ms(lambda n=n: fwd_bwd(ring(n))))
    zeros = torch.zeros(keep_shape, device=device)
    ones = torch.ones(keep_shape, device=device)
    drops = [ring_attention(zeros, zeros, ones, n_shards=max(shards),
                            dropout_rate=RING_RATE, dropout_seed=11,
                            dropout_site=2) for _ in range(2)]
    keep = float(drops[0].double().mean()) * (1.0 - RING_RATE)
    if not (torch.isfinite(drops[0]).all()
            and torch.equal(drops[0], drops[1])
            and abs(keep - (1.0 - RING_RATE)) <= 0.01 * (1.0 - RING_RATE)):
        raise AssertionError(f"ring: rate {RING_RATE}: keep share {keep}, "
                             f"finite and alike twice required")
    res["keep_share"] = keep
    if timed:
        # kernels 6 + 9 alone, [B, N, S, D], CUDA graph replay (the
        # kernel table's method), beside the eager autograd call
        qt, kt, vt, dyt = (t.transpose(1, 2).contiguous()
                           for t in (q, k, v, dy))
        none = torch.zeros((shape[0], 1, 1, shape[1]), device=device)
        o, lse = fa.flash_fwd(qt, kt, vt, none, causal=True)
        res["flash"] = dict(
            ms=eager_ms(lambda: fwd_bwd(lambda q, k, v: fa.flash_attention(
                q, k, v, causal=True)), reps=10, inner=3),
            kernels_ms=time_ms(lambda: fa.flash_fwd(
                qt, kt, vt, none, causal=True)) + time_ms(
                lambda: fa.flash_bwd(qt, kt, vt, none, o, lse, dyt,
                                     causal=True)))
        res["reference"] = call_ms(lambda: fwd_bwd(reference))
    say(f"[ring] ring attention at {list(shape)} bf16 causal, the sequence "
        f"in {list(shards)} shards driven in turn, against "
        f"reference_attention, forward + backward (flash: kernels 6 + 9 "
        f"at rate 0, for the record): " + json.dumps(res)
        + f" (tol {tol})")
    return res


def tp_cp_equal_phase(lm_argv=TINY_LM_ARGS, dp_argv=TINY_ARGS) -> dict:
    """At world size 1 on the card: ``train_lm --tp --no-scan-layers``
    against ``--no-scan-layers`` alone, ``train_lm --attention ring``
    against ``--attention reference`` and ``train_dp --attention ring``
    against ``--attention reference``: the steps and eval metrics bit for
    bit and the launches equal."""
    pairs = (
        ("train_lm --tp", "train_lm", lm_argv + ["--no-scan-layers"],
         ["--tp"]),
        ("train_lm --attention ring", "train_lm",
         lm_argv + ["--attention", "reference"], ["--attention", "ring"]),
        ("train_dp --attention ring", "train_dp",
         dp_argv + ["--attention", "reference"], ["--attention", "ring"]),
    )
    res = {}
    for what, cli, argv, flags in pairs:
        runs = []
        for extra in ([], flags):
            trainer, counts, _ = train_once(argv + extra
                                            + ["--device", "cuda"], cli)
            record = {k: v for k, v in trainer.history[0].items()
                      if not k.startswith("samples")}
            runs.append((trainer.step_log, record, counts))
            del trainer
        (steps, record, counts), (steps_b, record_b, counts_b) = runs
        if steps != steps_b or record != record_b or counts != counts_b:
            raise AssertionError(f"tp-cp-equal: {what}: {runs[1]} against "
                                 f"{runs[0]}")
        res[what] = dict(losses=[s["loss"] for s in steps],
                         launches=counts)
    say("[tp-cp-equal] at world size 1: bit for bit, launches equal: "
        + json.dumps(res))
    return res


# serve-tp-block: one gpt2-medium serving block (bf16 weights and pools, or
# int8 weights quantized whole then cut and int8 pools with fp32 scales) at
# the serve phase's decode tick (8 slots at SERVE_CONTEXTS) and a verify
# of VERIFY_Q rows, cut into model 2 and 4 slices in one process: each
# slice's bf16 partials rounded before their sum, as tp-split's
SERVE_TP_SIZES = (2, 4)
SERVE_TP_TOL = 3e-2
# serve-tp: serve_lm --tp 2 as two gloo processes on the one card, the
# option runs' requests, plain and int8
SERVE_TP_RUNS = (("serve-tp", []), ("serve-tp-int8", INT8))


def _serve_block(weights: str, seed: int = 0):
    """One gpt2-medium block cast for serving as the engine casts it
    (``cast_for_serving``: bf16, or int8 projections quantized whole),
    its biases off zero."""
    import torch

    from pytorch_distributed_training_tpu_torch.models.gpt2 import (
        GPT2LMModel,
    )
    from pytorch_distributed_training_tpu_torch.utils.config import (
        model_preset,
    )

    gen = torch.Generator().manual_seed(seed)
    model = GPT2LMModel(model_preset("gpt2-medium", num_layers=1),
                        generator=gen)
    with torch.no_grad():  # the replicated row-parallel biases count
        for name, p in model.blocks[0].named_parameters():
            if name.endswith("bias"):
                p.normal_(0.0, 0.02, generator=gen)
    model.cast_for_serving(weights)
    return model.blocks[0].eval().requires_grad_(False)


def _block_pools(device, *, int8, heads, head_dim, page_size, pages,
                 seed=0):
    """A block's K and V pools filled with noise (bf16, or int8 values
    with fp32 scales), as ``(k, v, k_scales, v_scales)``."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    shape = (pages, page_size, heads, head_dim)
    if not int8:
        return tuple(torch.randn(shape, generator=g, device=device).to(
            torch.bfloat16) for _ in range(2)) + (None, None)
    vals = tuple(torch.randint(-127, 128, shape, generator=g, device=device,
                               dtype=torch.int8) for _ in range(2))
    scales = tuple(torch.rand(shape[:3], generator=g, device=device) * 0.015
                   + 0.005 for _ in range(2))
    return vals + scales


def _pool_values(pools):
    """The pools' values in float32 (int8 ones times their scales)."""
    k, v, ks, vs = pools
    if ks is None:
        return k.float(), v.float()
    return k.float() * ks[..., None], v.float() * vs[..., None]


def serve_tp_block_check(device, m: int, *, int8: bool, q_len: int,
                         contexts=SERVE_CONTEXTS, windows=VERIFY_WINDOWS,
                         tol=SERVE_TP_TOL, timed=True, seed=0) -> dict:
    """One serving block (``_serve_block``), whole and cut into ``m``
    model-axis slices by ``serve_param_specs`` and ``tensor_parallel``
    with an in-process ``AxisShard`` (no group: each slice's collectives
    are the identity), each slice on its own pools at ``heads / m``
    (``serve_pool_shape``; the whole pools' heads), one paged dispatch of
    ``q_len`` rows a slot at ``contexts`` (1: the decode kernel, more: the
    multi-query kernel): the row-parallel partials summed here as the
    all-reduce sums them (the replicated biases on slice 0 alone), the
    block's output and each slice's pools after its writes against the
    whole's within ``tol`` (max |err| / max |want|; int8 pools
    dequantized), bit-equality of the writes recorded, the slices'
    launches counted; ``timed``: device ms of one slice's dispatch and of
    the whole block's (``kernel_ms_by_symbol``)."""
    import copy

    import torch
    import torch.nn.functional as F

    from pytorch_distributed_training_tpu_torch.comms.mesh import AxisShard
    from pytorch_distributed_training_tpu_torch.ops import _build
    from pytorch_distributed_training_tpu_torch.parallel.sharding import (
        serve_param_specs,
        serve_pool_shape,
        tensor_parallel,
    )

    whole = _serve_block("int8" if int8 else "float32", seed)
    cfg = whole.attention.config
    heads, head_dim, page_size = cfg.num_heads, cfg.head_dim, 16
    specs = serve_param_specs(
        {n: tuple(p.shape) for n, p in whole.named_parameters()}, m)
    slices = []
    for r in range(m):
        part = copy.deepcopy(whole)
        tensor_parallel(part, specs, AxisShard(group=None, index=r, size=m,
                                               ranks=tuple(range(m))))
        if r:
            part.attention.out.bias.zero_()
            part.mlp_down.bias.zero_()
        slices.append(part.to(device))
    whole = whole.to(device)
    batch = len(contexts)
    pages = batch * windows + 1
    pools = _block_pools(device, int8=int8, heads=heads, head_dim=head_dim,
                         page_size=page_size, pages=pages, seed=seed)
    bt = (torch.arange(batch * windows, dtype=torch.int32, device=device)
          .reshape(batch, windows) + 1)
    ctx = torch.tensor(contexts, dtype=torch.int32, device=device)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    x = torch.randn(batch, q_len, cfg.hidden_size, generator=g,
                    device=device).to(torch.bfloat16)
    mq = q_len > 1

    def own(pools, r):
        """Slice ``r``'s copy of ``pools``' heads."""
        per = heads // m
        out = tuple(None if t is None else
                    t[:, :, r * per:(r + 1) * per].contiguous()
                    for t in pools)
        want = serve_pool_shape(tuple(pools[0].shape), m)
        if tuple(out[0].shape) != want:
            raise AssertionError(f"serve-tp-block: pool {out[0].shape}, "
                                 f"want {want}")
        return out

    def layer(p):
        return (*p, bt, ctx, mq)

    whole_pools = tuple(None if t is None else t.clone() for t in pools)
    slice_pools = [own(pools, r) for r in range(m)]

    def whole_step():
        return whole(x, None, layer(whole_pools))

    def split_step():
        first = slices[0]
        a = first.ln_1(x)
        h = sum(s.attention(a, None, layer(p))
                for s, p in zip(slices, slice_pools))
        y = x + h
        c = first.ln_2(y)
        h = sum(s.mlp_down(F.gelu(s.mlp_up(c), approximate="tanh"))
                for s in slices)
        return y + h

    def one_slice_step():
        """Slice 0's share of the block (its dispatch on one rank, the
        all-reduces' inputs on the replicated residual stream)."""
        s, p = slices[0], slice_pools[0]
        y = x + s.attention(s.ln_1(x), None, layer(p))
        return y + s.mlp_down(F.gelu(s.mlp_up(s.ln_2(y)), approximate="tanh"))

    with torch.inference_mode():
        want = whole_step()
        _build.reset_launch_counts()
        got = split_step()
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCH_COUNTS)
        out_err = rel_err(got, want)
        pool_err, bit_equal = 0.0, True
        per = heads // m
        for r, p in enumerate(slice_pools):
            wants = tuple(None if t is None else t[:, :, r * per:(r + 1) * per]
                          for t in whole_pools)
            bit_equal &= all(a is None or torch.equal(a, b)
                             for a, b in zip(p, wants))
            for a, b in zip(_pool_values(p), _pool_values(wants)):
                pool_err = max(pool_err, rel_err(a, b))
        if not (torch.isfinite(got).all() and out_err <= tol
                and pool_err <= tol):
            raise AssertionError(
                f"serve-tp-block: model {m}, q_len {q_len}, int8 {int8}: "
                f"out {out_err}, pools {pool_err} (tol {tol})")
        kernel = ("paged_attention_mq" if mq else "paged_attention") + (
            "_int8" if int8 else "")
        if launches.get(kernel) != m:
            raise AssertionError(f"serve-tp-block: {kernel} launched "
                                 f"{launches.get(kernel)} times, want {m}")
        res = dict(model=m, heads=per, q_len=q_len, int8=int8, kernel=kernel,
                   out_err=out_err, pool_err=pool_err,
                   pool_writes_bit_equal=bool(bit_equal), launches=launches)
        if timed:
            res["slice_device_ms"] = sum(kernel_ms_by_symbol(
                one_slice_step, reps=10).values()) or None
            res["whole_device_ms"] = sum(kernel_ms_by_symbol(
                whole_step, reps=10).values()) or None
            res["slice_kernel_ms"] = kernel_ms_by_symbol(
                one_slice_step, reps=10)
    return res


def serve_tp_block_phase(device, sizes=SERVE_TP_SIZES) -> list:
    """``serve_tp_block_check`` at each model-axis size, on float and int8
    pools, at the decode tick (kernel 12 or 12-int8) and the verify
    (kernel 13 or 13-int8)."""
    out = []
    for m in sizes:
        for int8 in (False, True):
            for q_len in (1, VERIFY_Q):
                res = serve_tp_block_check(device, m, int8=int8, q_len=q_len)
                say(f"[serve-tp-block] gpt2-medium serving block, "
                    f"{'int8 weights and pools' if int8 else 'bf16'}, "
                    f"{len(SERVE_CONTEXTS)} slots x {q_len} rows, cut into "
                    f"{m} model-axis slices ({res['heads']} heads a slice): "
                    + json.dumps(res) + f" (tol {SERVE_TP_TOL})")
                out.append(res)
    return out


def serve_tp_child(rank: int, ports: list, argv=SERVE_ARGS,
                   prompts=OPTION_PROMPTS,
                   new_tokens=OPTION_NEW_TOKENS) -> dict:
    """One rank of the serve-tp phase: for each of SERVE_TP_RUNS, a gloo
    group of two processes on this card (NCCL takes one rank a device),
    then ``serve_lm.main`` with ``--tp 2`` (its ``initialize`` joins the
    group made here; rank 0 serves the requests); this rank's events,
    stats, launches and wall seconds by run."""
    import torch.distributed as dist

    from pytorch_distributed_training_tpu_torch.cli import serve_lm
    from pytorch_distributed_training_tpu_torch.ops import _build

    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK="0")
    out = {}
    for (name, flags), port in zip(SERVE_TP_RUNS, ports):
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=2)
        text = request_lines(prompts, new_tokens) if rank == 0 else ""
        buf = io.StringIO()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        stats = serve_lm.main(argv + flags + ["--tp", "2", "--warmup"],
                              in_stream=io.StringIO(text), out_stream=buf)
        out[name] = dict(stats=stats, launches=dict(_build.LAUNCH_COUNTS),
                         wall_s=time.perf_counter() - t0,
                         events=[json.loads(line) for line in
                                 buf.getvalue().splitlines()])
        if dist.is_initialized():
            raise AssertionError("serve_lm --tp left its group up")
    return out


def serve_tp_start(argv=SERVE_ARGS, prompts=OPTION_PROMPTS,
                   new_tokens=OPTION_NEW_TOKENS) -> list:
    """The serve-tp phase's two processes (``serve_tp_child``), started;
    ``serve_tp_phase`` reads them."""
    import socket

    ports = []
    for _ in SERVE_TP_RUNS:
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            ports.append(sock.getsockname()[1])
    procs = []
    for rank in range(2):
        code = (f"import json, sys; sys.path.insert(0, {ROOT!r}); "
                f"import chip_smoke; print('SERVE_TP ' + json.dumps("
                f"chip_smoke.serve_tp_child({rank}, *json.loads(sys.argv[1]))"
                f"))")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code,
             json.dumps([ports, list(argv), list(prompts), new_tokens])],
            cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    return procs


def serve_tp_phase(procs, plain_streams, int8_streams, argv=SERVE_ARGS,
                   prompts=OPTION_PROMPTS, new_tokens=OPTION_NEW_TOKENS,
                   n_layers=24, heads=16) -> dict:
    """``serve_lm --tp 2`` on the card as two processes (``serve_tp_child``,
    gloo: its all-reduces and broadcasts take the card's tensors through
    the host), plain and int8: rank 0's streams, each request's token
    count, ``stats()["tp"]``, the page count of tp=1's engine, half the
    heads in each rank's pools, each rank's launches against the leader's
    dispatch counts, the follower's calls, both exits 0; how many streams
    equal tp=1's first ``new_tokens`` (``plain_streams``,
    ``int8_streams``). ``argv``: the serve phase's; ``procs``: the two
    processes of ``serve_tp_start``, started earlier beside lm-fsdp and
    mp-cp (the card and the host's cores are shared while they run)."""
    from pytorch_distributed_training_tpu_torch.cli import serve_lm

    ranks = []
    try:
        for rank, proc in enumerate(procs):
            stdout, stderr = proc.communicate(timeout=600)
            result = None
            for line in stdout.splitlines():
                if line.startswith("SERVE_TP "):
                    result = json.loads(line[len("SERVE_TP "):])
                else:
                    say(f"[serve-tp] rank {rank}: {line}")
            if proc.returncode != 0 or result is None:
                raise AssertionError(f"serve-tp: rank {rank} exit "
                                     f"{proc.returncode}: {stderr[-3000:]}")
            ranks.append(result)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    pages = serve_lm.engine_config(
        serve_lm.build_parser().parse_args(argv)).total_pages - 1
    res = {}
    for (name, _), tp1 in zip(SERVE_TP_RUNS, (plain_streams, int8_streams)):
        leader, follower = ranks[0][name], ranks[1][name]
        stats, fstats = leader["stats"], follower["stats"]
        toks = streams(leader["events"], prompts, new_tokens)
        if follower["events"]:
            raise AssertionError(f"{name}: the follower wrote events")
        if (stats["tp"] != 2 or fstats["tp"] != 2
                or stats["kv_pages_total"] != pages
                or not stats["kv_heads"] == fstats["kv_heads"] == heads // 2):
            raise AssertionError(f"{name}: stats {stats} follower {fstats}")
        # the warm-up's dispatches (--warmup: each bucket, a decode) count
        want = serve_option_launches(with_warmup(stats), n_layers)
        for rank, r in ((0, leader), (1, follower)):
            check_launches(f"{name} rank {rank}", r["launches"], want)
        calls = (stats["prefill_dispatches"] + stats["prefill_chunks"]
                 + stats["decode_dispatches"]
                 + sum(stats["warmup_dispatches"].values()))
        if fstats["calls"] != calls:
            raise AssertionError(f"{name}: follower ran {fstats['calls']} "
                                 f"calls, the leader dispatched {calls}")
        # each rank's audit of the hot program's window: its 2 x 24
        # row-parallel all-reduces, clean against serve_tp_manifest
        audits = [r["stats"]["comm_audit"] for r in (leader, follower)]
        check_serve_guards(f"{name} leader", stats)
        if any(a is None or not a["ok"] or set(a["by_kind"]) != {
                "all-reduce"} or a["by_kind"]["all-reduce"]["count"]
                != 2 * n_layers for a in audits):
            raise AssertionError(f"{name}: comm audits {audits}")
        m = dict(
            serve_metrics(leader["events"], stats, leader["wall_s"]),
            follower_wall_s=follower["wall_s"], calls=calls,
            kv_heads=stats["kv_heads"], kv_pages_total=pages,
            weight_bytes=stats["weight_bytes"],
            follower_weight_bytes=fstats["weight_bytes"],
            kv_bytes_per_token=stats["kv_bytes_per_token"],
            launches=leader["launches"],
            follower_launches=follower["launches"],
            comm_audit={k: audits[0][k] for k in (
                "ok", "count", "total_bytes", "total_moved_bytes")},
            streams_equal_tp1=sum(toks[r] == tp1[r][:new_tokens]
                                  for r in toks))
        say(f"[{name}] serve_lm --tp 2, two gloo processes on one card: "
            + json.dumps(m))
        res[name] = dict(m, streams=toks)
    return res


# ------------------------------------------------------------- int8 training


def int8_gemm_phase(device,
                    sites=INT8_GEMM_SITES + INT8_GEMM_PADDED) -> dict:
    """``ops/quant.int8_mm`` (``torch._int_mm``) at bert-large's six dense
    sites and a padded shape, forward, dgrad and wgrad, each bit-equal to
    the float64 product of the same int8 operands (exact: every sum is
    under 2^53), timed beside the bf16 ``torch.matmul`` of the same shape,
    with the bound at the int8 rate."""
    import torch

    from pytorch_distributed_training_tpu_torch.ops.quant import int8_mm

    g = torch.Generator(device=device).manual_seed(0)
    res = {}
    for site, tokens, k, n in sites:
        for kind, (m, kk, nn) in (("fwd", (tokens, k, n)),
                                  ("dgrad", (tokens, n, k)),
                                  ("wgrad", (k, tokens, n))):
            a = torch.randint(-127, 128, (m, kk), dtype=torch.int8,
                              device=device, generator=g)
            bt = torch.randint(-127, 128, (nn, kk), dtype=torch.int8,
                               device=device, generator=g)
            got = int8_mm(a, bt)
            want = torch.matmul(a.double(), bt.double().t()).to(torch.int32)
            if got.dtype != torch.int32 or not torch.equal(got, want):
                raise AssertionError(f"int8-gemm {site} {kind}: not the "
                                     f"exact product")
            af, bf = a.bfloat16(), bt.t().contiguous().bfloat16()
            ms = time_ms(lambda: int8_mm(a, bt))
            bf16_ms = time_ms(lambda: torch.matmul(af, bf))
            b_ms, by = bound(m * kk + nn * kk + 4 * m * nn, 2 * m * kk * nn,
                             INT8_OPS_PER_S)
            res[f"{site}-{kind}"] = dict(
                m=m, k=kk, n=nn, ms=ms, bf16_ms=bf16_ms,
                ratio=ms / bf16_ms, bound_ms=b_ms, bound_by=by,
                tops=2 * m * kk * nn / ms / 1e9)
    say("[int8-gemm] torch._int_mm bit-equal to the exact product at "
        "bert-large's six sites (fwd, dgrad, wgrad), ms beside the bf16 "
        "matmul: " + json.dumps(res))
    return res


def train_int8_phase(root: str, argv=INT8_TRAIN_ARGS,
                     variants=INT8_VARIANTS) -> dict:
    """``train_dp`` on bert-large at full width and depth, native and each
    int8 variant: 2 steps and the eval, counted as the train phase counts,
    finite losses, every parameter moved, step 1's loss within
    INT8_LOSS_ATOL of native's, ms a step beside native's; the last variant
    (delayed scales) with a checkpoint a step under ``root`` (its ms a
    step then holds the saves' submits, so it has no ratio to native's),
    resumed from its step 1 (``int8_resume_phase``: step 2 bit-equal)."""
    import torch

    ck = os.path.join(root, "int8-large")
    saved = variants[-1][1] + ["--checkpoint-every-steps", "1",
                               "--checkpoint-dir", ck]
    variants = variants[:-1] + ((variants[-1][0], saved),)
    runs = {}
    for name, flags in (("native", []), *variants):
        torch.cuda.reset_peak_memory_stats()
        with no_mask_tensor(f"train-int8 {name} run"):
            trainer, counts, wall = train_once(argv + flags)
        check_launches(f"train-int8 {name} run", counts,
                       train_launches(trainer))
        m = train_metrics(trainer, wall)
        m["launches"] = counts
        if name == "native":  # train-options' run 1, the defaults
            m.update(peak_mem_bytes=torch.cuda.max_memory_allocated(),
                     moment_bytes=moment_bytes(trainer),
                     digest=weights_digest(trainer.state.module))
        if m["steps"] != 2 or not all(
                map(math.isfinite, m["losses"] + m["grad_norms"])):
            raise AssertionError(f"train-int8 {name}: {m}")
        start = initial_weights(trainer)
        now = trainer.state.module.state_dict()
        unmoved = [k for k in start if torch.equal(now[k].cpu(), start[k])]
        if unmoved:
            raise AssertionError(f"train-int8 {name}: unchanged after 2 "
                                 f"steps: {unmoved[:5]}")
        del start, now
        if flags is saved:
            m["digest"] = weights_digest(trainer.state.module)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        runs[name] = m
        if name != "native":
            d = abs(m["losses"][0] - runs["native"]["losses"][0])
            m["step1_loss_diff"] = d
            if flags is not saved:
                m["ms_per_step_vs_native"] = (
                    m["ms_per_step"] / runs["native"]["ms_per_step"])
            if d > INT8_LOSS_ATOL:
                raise AssertionError(
                    f"train-int8 {name}: step 1 loss {m['losses'][0]} vs "
                    f"native {runs['native']['losses'][0]} (atol "
                    f"{INT8_LOSS_ATOL})")
        say(f"[train-int8] {name}: " + json.dumps(m))
    runs["resumed"] = int8_resume_phase(argv + saved,
                                        runs[variants[-1][0]])
    return runs


def train_options_phase(defaults: dict, argv=INT8_TRAIN_ARGS,
                        runs=OPTION_TRAIN_RUNS) -> dict:
    """The trainer options at bert-large (train-int8's shape: 2 steps of 32
    = 4 x 8, seq 128, seed 42), run 1 the defaults (train-int8's native
    run, ``defaults``): the bfloat16 moments and the bfloat16 carry (ms a
    step, the run's peak, the moments' bytes), ``--chain-steps 2`` (its one
    loss the float32 mean of run 1's two, computed on the card the same
    way, bit for bit, and the final weights run 1's), ``--profile-dir``
    for one step (the trace holds ``train_step`` ranges and kernels 1-5's
    symbols) and ``--debug-nans`` for one step (clean, ms a step), then a
    NaN planted in one weight, which must raise ``FloatingPointError``."""
    import torch

    from pytorch_distributed_training_tpu_torch.utils.profiling import (
        set_debug_nans,
    )

    keep = ("ms_per_step", "losses", "engine", "data_wait_p50_s",
            "peak_mem_bytes", "moment_bytes")
    res = {"defaults": {k: defaults[k] for k in keep}}
    say("[train-options] defaults (train-int8's native run): "
        + json.dumps(res["defaults"]))
    for name, flags in runs:
        torch.cuda.reset_peak_memory_stats()
        with no_mask_tensor(f"train-options {name} run"):
            trainer, counts, wall = train_once(argv + flags)
        check_launches(f"train-options {name} run", counts,
                       train_launches(trainer))
        m = train_metrics(trainer, wall)
        m.update(peak_mem_bytes=torch.cuda.max_memory_allocated(),
                 moment_bytes=moment_bytes(trainer), launches=counts)
        if not all(map(math.isfinite, m["losses"] + m["grad_norms"])):
            raise AssertionError(f"train-options {name}: {m}")
        if name == "chain-2":
            want = float(torch.tensor(defaults["losses"], dtype=torch.float32,
                                      device="cuda").mean())
            if (m["losses"] != [want] or weights_digest(
                    trainer.state.module) != defaults["digest"]):
                raise AssertionError(
                    f"train-options chain-2: loss {m['losses']} against the "
                    f"mean {want} of {defaults['losses']}, or other weights")
            m["chain_mean_equal"] = m["weights_equal"] = True
        elif len(m["losses"]) != 2:
            raise AssertionError(f"train-options {name}: {m}")
        del trainer
        _free_cuda()
        res[name] = m
        say(f"[train-options] {name}: " + json.dumps(m))
    one = one_step(argv, "32")
    with tempfile.TemporaryDirectory(prefix="pdt_chip_smoke_") as d:
        trainer, counts, wall = train_once(one + ["--profile-dir", d])
        traces = [os.path.join(d, f) for f in os.listdir(d)
                  if f.endswith(".pt.trace.json")]
        if len(traces) != 1:
            raise AssertionError(f"train-options profile: {os.listdir(d)}")
        with open(traces[0]) as f:
            events = json.load(f)["traceEvents"]
        size = os.path.getsize(traces[0])
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    ranges = sum(e.get("name") == "train_step" for e in events)
    missing = [sym for sym in TRAIN_KERNEL_SYMBOLS
               if not any(sym in k for k in kernels)]
    if not ranges or missing:
        raise AssertionError(f"train-options profile: {ranges} train_step "
                             f"ranges, kernels missing {missing}")
    res["profile"] = dict(ms_per_step=train_metrics(trainer, wall)[
        "ms_per_step"], train_step_ranges=ranges, trace_bytes=size,
        kernel_symbols=len(kernels), launches=counts)
    del trainer, events
    _free_cuda()
    say("[train-options] profile: " + json.dumps(res["profile"]))
    try:
        trainer, counts, wall = train_once(one + ["--debug-nans"])
        clean = train_metrics(trainer, wall)
        with torch.no_grad():  # the drill: a NaN in one weight
            trainer.state.module.classifier.kernel.view(-1)[0] = float("nan")
        batch = next(iter(trainer.train_loader.epoch(0)))
        try:
            trainer.train_step(trainer.state, batch)
        except FloatingPointError as e:
            raised = str(e)
        else:
            raise AssertionError("train-options debug-nans: a NaN weight "
                                 "raised nothing")
        finally:
            for loader in trainer.loaders:
                loader.close()
    finally:
        set_debug_nans(False)
    res["debug_nans"] = dict(ms_per_step=clean["ms_per_step"],
                             losses=clean["losses"], drill=raised)
    del trainer, batch
    _free_cuda()
    say("[train-options] debug-nans: " + json.dumps(res["debug_nans"]))
    return res


def int8_resume_phase(argv, want: dict) -> dict:
    """The delayed-int8 run's checkpoint at full width (bert-large's
    padded ``_int_mm`` shapes and its amax count): step 2 taken away, a
    run resumed from step 1, counted from its construction: the amaxes step
    1 saved restored, no calibration launch, and step 2's loss, grad norm
    and every weight and amax bit-equal to the uninterrupted run's
    (``want``)."""
    import torch

    from pytorch_distributed_training_tpu_torch.cli import train_dp
    from pytorch_distributed_training_tpu_torch.ops import _build
    from pytorch_distributed_training_tpu_torch.train import checkpoint

    ck = argv[argv.index("--checkpoint-dir") + 1]
    saved = {k: v for k, v in checkpoint.restore_params(ck, step=1).items()
             if k.endswith("amax")}
    shutil.rmtree(checkpoint.step_path(ck, 2))
    _build.reset_launch_counts()
    with no_mask_tensor("train-int8 resumed run"):
        resumed = train_dp.build_trainer(
            train_dp.build_parser().parse_args(argv + ["--resume"]))
        live = resumed.state.module.state_dict()
        if not saved or any(not torch.equal(live[k].cpu(), v)
                            for k, v in saved.items()):
            raise AssertionError("train-int8 resume: the amaxes differ "
                                 "from step 1's")
        del live
        resumed.run()
    counts = dict(_build.LAUNCH_COUNTS)
    tc, mc = resumed.tcfg, resumed.mcfg
    restore = resumed.checkpointer.restores[-1]
    if not mc.quant_delayed_grads or restore["step"] != 1:
        raise AssertionError(f"train-int8 resume: restored {restore}")
    check_launches("train-int8 resumed run (1 step, no calibration)", counts,
                   expected_train_launches(
                       micro=tc.grad_accum_steps,
                       eval_batches=resumed.eval_loader.steps_per_epoch,
                       layers=mc.num_layers))
    got = [[s["loss"], s["grad_norm"]] for s in resumed.step_log]
    if (got != [[want["losses"][1], want["grad_norms"][1]]]
            or weights_digest(resumed.state.module) != want["digest"]):
        raise AssertionError(f"train-int8 resume: step 2 {got} against "
                             f"{want['losses']}, {want['grad_norms']}")
    del resumed
    _free_cuda()
    shutil.rmtree(ck, ignore_errors=True)
    res = dict(step2=got[0], amax_buffers=len(saved), restore=restore,
               launches=counts)
    say("[train-int8] bert-large, int8_full, delayed scales on both passes, "
        "resumed from step 1: step 1's amaxes restored, no calibration "
        "launch, step 2's loss, grad norm and every weight bit-equal to the "
        "uninterrupted run's: " + json.dumps(res))
    return res


def mp_cp_child(rank: int, port: int, mode: str, seq: int,
                device: str = "cuda") -> dict:
    """One rank of ``train_mp``'s ``mode`` on the tiny preset at a seq axis
    of ``seq`` (ring attention; 1: reference attention, no group): with
    ``seq`` > 1 a gloo group of that many processes on this card (NCCL
    takes one rank a device) is made first and the Trainer joins it.
    Float32, dropout off; the per-step losses and grad norms."""
    import torch.distributed as dist

    from pytorch_distributed_training_tpu_torch.comms.bootstrap import (
        shutdown,
    )
    from pytorch_distributed_training_tpu_torch.models.branch import (
        BranchEnsembleClassifier,
    )
    from pytorch_distributed_training_tpu_torch.train.loop import Trainer
    from pytorch_distributed_training_tpu_torch.utils.config import (
        MeshConfig,
        TrainConfig,
        model_preset,
    )

    if seq > 1:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(seq),
                          LOCAL_RANK="0")
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=seq)
    try:
        mcfg = model_preset(
            "tiny", compute_dtype="float32", hidden_dropout=0.0,
            attention_dropout=0.0,
            attention_impl="ring" if seq > 1 else "reference")
        model = None
        if mode == "branch":
            def model(cfg, *, seed, mesh):
                return BranchEnsembleClassifier(cfg, 2, seed=seed, mesh=mesh)
        trainer = Trainer(mcfg, TrainConfig(**MP_CP_TRAIN), task="synthetic",
                          device=device, mesh_config=MeshConfig(data=1,
                                                                seq=seq),
                          mp_mode=mode, model=model,
                          n_micro=2 if mode in ("pipeline", "1f1b") else None)
        trainer.run()
        out = dict(steps=[(s["loss"], s["grad_norm"])
                          for s in trainer.step_log],
                   accuracy=trainer.history[-1]["accuracy"])
        if seq > 1:
            out["all_reduce_max_us"] = scalar_max_us(trainer.device)
        return out
    finally:
        shutdown()


def mp_cp_modes_child(rank: int, ports: list, modes: list, seq: int,
                      device: str = "cuda") -> dict:
    """One rank of every mode of ``modes`` in turn (``mp_cp_child``, a
    gloo group a mode on its port of ``ports``), in one process."""
    return {mode: mp_cp_child(rank, port, mode, seq, device)
            for mode, port in zip(modes, ports)}


def scalar_max_us(device, calls: int = 200) -> float:
    """Host microseconds of one ``all_reduce_max`` of a float32 scalar on
    ``device`` over the world group (an int8 site's amax collective), the
    mean of ``calls`` back to back."""
    import torch
    import torch.distributed as dist

    from pytorch_distributed_training_tpu_torch.comms.collectives import (
        all_reduce_max,
    )

    t = torch.ones((), device=device)
    for _ in range(10):
        all_reduce_max(t, dist.group.WORLD)
    if t.is_cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        all_reduce_max(t, dist.group.WORLD)
    if t.is_cuda:
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def mp_cp_phase(modes=MP_CP_MODES, device="cuda") -> dict:
    """``train_mp --mesh-seq 2`` under each of ``modes`` as two gloo
    processes on the card, the modes one after another in the same two
    processes (``mp_cp_modes_child``): both exit 0, and the losses and
    grad norms equal one process's at seq 1 (reference attention) within
    MP_CP_RTOL."""
    import socket

    ports = []
    for _ in modes:
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            ports.append(sock.getsockname()[1])
    procs = []
    for rank in range(2):
        code = (f"import json, sys; sys.path.insert(0, {ROOT!r}); "
                f"import chip_smoke; print('MP_CP ' + json.dumps("
                f"chip_smoke.mp_cp_modes_child({rank}, {ports!r}, "
                f"{list(modes)!r}, 2, {device!r})))")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    ranks = []
    try:
        for rank, proc in enumerate(procs):
            stdout, stderr = proc.communicate(timeout=600)
            found = [json.loads(line[len("MP_CP "):])
                     for line in stdout.splitlines()
                     if line.startswith("MP_CP ")]
            if proc.returncode != 0 or not found:
                raise AssertionError(f"mp-cp: rank {rank} exit "
                                     f"{proc.returncode}: {stderr[-3000:]}")
            ranks.append(found[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    res = {}
    for mode in modes:
        seq2 = [r[mode] for r in ranks]
        one = mp_cp_child(0, 0, mode, 1, device)
        us = [r.pop("all_reduce_max_us") for r in seq2]
        if seq2[0] != seq2[1] or len(one["steps"]) != len(seq2[0]["steps"]):
            raise AssertionError(f"mp-cp {mode}: ranks {seq2} one {one}")
        for got, want in zip(seq2[0]["steps"], one["steps"]):
            for a, b in zip(got, want):
                if not math.isclose(a, b, rel_tol=MP_CP_RTOL):
                    raise AssertionError(
                        f"mp-cp {mode}: seq 2 {seq2[0]['steps']} against "
                        f"seq 1 {one['steps']} (rtol {MP_CP_RTOL})")
        res[mode] = dict(seq2=seq2[0], seq1=one, all_reduce_max_us=us,
                         max_rel_diff=max(
            abs(a - b) / abs(b) for got, want in zip(seq2[0]["steps"],
                                                     one["steps"])
            for a, b in zip(got, want)))
        say(f"[mp-cp] train_mp --mp-mode {mode} --mesh-seq 2, two gloo "
            "processes on one card, against --mesh-seq 1: "
            + json.dumps(res[mode]))
    return res


# ------------------------------------------------------------------- main


# ------------------------------------------- checkpoints and generation

# ckpt-resume: gpt2-medium at full width and depth and train_lm's seq 128,
# 2 steps of 16 = 2 x 8 and a 16-row eval, a checkpoint every step
CKPT_LM_ARGS = ["--model", "gpt2-medium", "--task", "lm", "--train-size", "32",
                "--eval-size", "16", "--global-batch-size", "16",
                "--micro-batch-size", "8", "--num-epochs", "1", "--seed", "42",
                "--warmup-steps", "1", "--log-every", "0", "--device", "cuda",
                "--checkpoint-every-steps", "1"]
# ckpt-int8: the tiny preset at int8_full with delayed scales on both
# passes, 2 steps, a checkpoint every step
CKPT_INT8_ARGS = TINY_INT8_ARGS + ["--device", "cuda",
                                   "--checkpoint-every-steps", "1"]
# generate and serve-ckpt: the serve phase's prompts and new tokens, greedy
GENERATE_ARGS = ["--model", "gpt2-medium", "--device", "cuda",
                 "--no-stop-at-eot"]
SERVE_CKPT_ARGS = ["--model", "gpt2-medium", "--device", "cuda",
                   "--num-slots", "8", "--prompt-buckets", "16,32,64,128",
                   "--max-new-tokens-cap", "64"]


def weights_digest(module) -> str:
    """sha256 of every tensor of ``module``'s ``state_dict``, in order."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for name, t in module.state_dict().items():
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().view(-1).view(
            torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _lm_trainer(argv):
    from pytorch_distributed_training_tpu_torch.cli import train_lm

    return train_lm.build_trainer(train_lm.build_parser().parse_args(argv))


def _free_cuda():
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def sync_save(state, directory: str) -> float:
    """The synchronous save the Checkpointer made before its saves went
    asynchronous (the A/B's reference): ``torch.distributed.checkpoint
    .save`` from where the state lies into ``.tmp-<step>``, the rename and
    the sealed manifest, all before it returns; its seconds."""
    import torch.distributed.checkpoint as dcp

    from pytorch_distributed_training_tpu_torch.train import checkpoint
    from pytorch_distributed_training_tpu_torch.train import manifest

    t0 = time.perf_counter()
    os.makedirs(directory, exist_ok=True)
    path = checkpoint.step_path(directory, state.step)
    tmp = os.path.join(directory, f".tmp-{state.step}")
    saveable = checkpoint._saveable(state)
    tree = manifest.tree_summary(saveable)
    with checkpoint._quiet():
        dcp.save(saveable, storage_writer=dcp.FileSystemWriter(
            tmp, thread_count=checkpoint.WRITE_THREADS))
    os.rename(tmp, path)
    manifest._fsync_path(directory)
    manifest.write_manifest(path, manifest.build_manifest(path, state.step,
                                                          tree=tree))
    return time.perf_counter() - t0


def ckpt_async_ab(state, root: str) -> dict:
    """The same gpt2-medium step saved asynchronously (the Checkpointer:
    the submit, which returns once the host copy is whole, then the join,
    timed apart) and synchronously (``sync_save``), in turns: async, sync,
    async. One Checkpointer serves both async turns, so the second reuses
    its pinned buffers as a training run's later saves do."""
    from pytorch_distributed_training_tpu_torch.train import checkpoint

    adir, sdir = os.path.join(root, "ab-async"), os.path.join(root, "ab-sync")
    saver = checkpoint.Checkpointer(adir)
    turns = []
    for kind in ("async", "sync", "async"):
        if kind == "async":
            saver.save(state)
            saver.wait()
            entry = saver.saves[-1]
            turns.append(dict(kind=kind, submit_s=entry["submit_s"],
                              join_s=entry["join_s"],
                              total_s=entry["submit_s"] + entry["join_s"],
                              bytes=entry["bytes"]))
            shutil.rmtree(checkpoint.step_path(adir, state.step))
        else:
            turns.append(dict(kind=kind, total_s=sync_save(state, sdir)))
            shutil.rmtree(sdir)
    saver.close()
    shutil.rmtree(adir, ignore_errors=True)
    return dict(turns=turns)


def ckpt_kill_child(directory: str) -> None:
    """The kill drill's process: the tiny preset on the card, a checkpoint
    a step, killed (``os._exit``) right after the submit of step 2,
    before its join."""
    from pytorch_distributed_training_tpu_torch.cli import train_dp

    trainer = train_dp.build_trainer(train_dp.build_parser().parse_args(
        DRILL_ARGS + ["--checkpoint-dir", directory]))
    submit = trainer.checkpointer._submit

    def dying(state, step):
        submit(state, step)
        if step == 2:
            os._exit(13)

    trainer.checkpointer._submit = dying
    trainer.run()


def ckpt_kill_start(root: str):
    """Start ``ckpt_kill_child`` in a process of its own (the tiny preset
    beside the phase's gpt2-medium runs); ``ckpt_kill_phase`` reads it."""
    ck = os.path.join(root, "kill")
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); import chip_smoke; "
            f"chip_smoke.ckpt_kill_child({ck!r})")
    return ck, subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)


def ckpt_kill_phase(ck: str, proc) -> dict:
    """The kill drill's process (``ckpt_kill_start``) exited 13, only the
    hidden ``.tmp-2`` is left beside the sealed step 1, and a resumed run
    restores step 1."""
    from pytorch_distributed_training_tpu_torch.cli import train_dp
    from pytorch_distributed_training_tpu_torch.train import checkpoint

    _, err = proc.communicate(timeout=300)
    left = sorted(os.listdir(ck)) if os.path.isdir(ck) else []
    if (proc.returncode != 13 or checkpoint.all_steps(ck) != [1]
            or ".tmp-2" not in left):
        raise AssertionError(f"ckpt-kill: exit {proc.returncode}, left "
                             f"{left}: {err[-3000:]}")
    resumed = train_dp.build_trainer(train_dp.build_parser().parse_args(
        DRILL_ARGS + ["--checkpoint-dir", ck, "--resume"]))
    restore = resumed.checkpointer.restores[-1]
    if resumed.state.step != 1 or restore["step"] != 1:
        raise AssertionError(f"ckpt-kill: restored {restore}")
    resumed.checkpointer.close()
    del resumed
    shutil.rmtree(ck, ignore_errors=True)
    res = dict(exit=proc.returncode, left=left, restore=restore)
    say("[ckpt-resume] killed between the submit of step 2 and its join: "
        "only .tmp-2 beside step 1, the resume falls back to step 1: "
        + json.dumps(res))
    return res


def ckpt_resume_phase(root: str) -> dict:
    """``train_lm`` on gpt2-medium with a checkpoint every step: 2 steps
    uninterrupted (each save's submit and join), the async/sync A/B on its
    final state (``ckpt_async_ab``), then, with step 2 taken away, a run
    resumed from step 1 (counted) that takes step 2: its loss and grad
    norm and every weight bit-equal to the uninterrupted run's; the bytes,
    save and restore seconds; then the kill drill (``ckpt_kill_phase``).
    Returns the directory (steps 1 and the resumed run's 2)."""
    import torch

    from pytorch_distributed_training_tpu_torch.ops import _build
    from pytorch_distributed_training_tpu_torch.train import checkpoint

    kill = ckpt_kill_start(root)
    ck = os.path.join(root, "lm")
    argv = CKPT_LM_ARGS + ["--checkpoint-dir", ck]
    full, _, wall = train_once(argv, "train_lm")
    saves = full.checkpointer.saves
    if ([s["step"] for s in saves] != [1, 2]
            or checkpoint.all_steps(ck) != [1, 2]):
        raise AssertionError(f"ckpt-resume: saves {saves}, steps "
                             f"{checkpoint.all_steps(ck)}")
    want_log = full.step_log
    want = {k: v.detach().cpu().clone()
            for k, v in full.state.module.state_dict().items()}
    ab = ckpt_async_ab(full.state, root)
    say("[ckpt-resume] gpt2-medium step saved asynchronously (submit, then "
        "join) and synchronously, in turns: " + json.dumps(ab))
    del full
    _free_cuda()
    # the run stopped after step 1's save
    shutil.rmtree(checkpoint.step_path(ck, 2))
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resumed = _lm_trainer(argv + ["--resume"])
    restore = resumed.checkpointer.restores[-1]
    if resumed.state.step != 1 or restore["step"] != 1:
        raise AssertionError(f"ckpt-resume: restored {restore}")
    digest = weights_digest(resumed.state.module)
    resumed.run()
    torch.cuda.synchronize()
    resumed_wall = time.perf_counter() - t0
    counts = dict(_build.LAUNCH_COUNTS)
    tc, mc = resumed.tcfg, resumed.mcfg
    check_launches(
        "ckpt-resume resumed run (1 step)", counts, expected_lm_launches(
            micro=tc.grad_accum_steps,
            eval_batches=resumed.eval_loader.steps_per_epoch,
            layers=mc.num_layers, whole=True))
    if resumed.step_log != want_log[1:]:
        raise AssertionError(f"ckpt-resume: resumed step {resumed.step_log} "
                             f"against {want_log[1:]}")
    got = resumed.state.module.state_dict()
    differ = [k for k in want if not torch.equal(got[k].cpu(), want[k])]
    if differ:
        raise AssertionError(f"ckpt-resume: weights differ {differ[:5]}")
    resave = resumed.checkpointer.saves[0]
    del resumed, got, want
    _free_cuda()
    res = dict(
        steps=want_log, save=saves, resave=resave, restore=restore,
        bytes_a_step=saves[0]["bytes"], uninterrupted_wall_s=wall,
        resumed_wall_s=resumed_wall, launches=counts,
        scanned=mc.scan_layers, async_ab=ab)
    say("[ckpt-resume] gpt2-medium, seq 128, 2 steps of 16, a checkpoint a "
        "step: resumed from step 1, step 2's loss, grad norm and every "
        "weight bit-equal to the uninterrupted run's: " + json.dumps(res))
    res["kill"] = ckpt_kill_phase(*kill)
    return dict(res, dir=ck, restored_digest=digest)


def ckpt_fallback_phase(resume: dict) -> dict:
    """The newest step's largest file damaged (same length), a restore at
    ``--checkpoint-verify digest`` falls back to step 1: the weights of
    the resumed run's restore, by digest."""
    from pytorch_distributed_training_tpu_torch.faults.inject import (
        corrupt_step_dir,
    )
    from pytorch_distributed_training_tpu_torch.train import checkpoint

    ck = resume["dir"]
    victim = corrupt_step_dir(checkpoint.step_path(ck, 2))
    trainer = _lm_trainer(CKPT_LM_ARGS + [
        "--checkpoint-dir", ck, "--resume", "--checkpoint-verify", "digest"])
    restore = trainer.checkpointer.restores[-1]
    if (trainer.state.step != 1 or weights_digest(trainer.state.module)
            != resume["restored_digest"]):
        raise AssertionError(f"ckpt-fallback: restored {restore}")
    del trainer
    _free_cuda()
    res = dict(damaged=os.path.relpath(victim, ck), restore=restore)
    say("[ckpt-resume] step 2 damaged, the digest restore fell back to step "
        "1: " + json.dumps(res))
    return res


def ckpt_int8_phase(root: str, argv=CKPT_INT8_ARGS) -> dict:
    """The tiny preset at int8_full with delayed scales on both passes: 2
    steps with a checkpoint each, then a run resumed from step 1 counted
    from its construction: no calibration launch, step 2's loss and grad
    norm and the amaxes bit-equal to the uninterrupted run's."""
    import torch

    from pytorch_distributed_training_tpu_torch.train import checkpoint

    ck = os.path.join(root, "int8")
    argv = argv + ["--checkpoint-dir", ck]
    full, _, _ = train_once(argv)
    want_log = full.step_log
    want = {k: v.detach().cpu().clone()
            for k, v in full.state.module.state_dict().items()}
    del full
    shutil.rmtree(checkpoint.step_path(ck, 2))
    resumed, counts, _ = train_once(argv + ["--resume"])
    tc, mc = resumed.tcfg, resumed.mcfg
    if not mc.quant_delayed_grads or resumed.checkpointer.restores[-1][
            "step"] != 1:
        raise AssertionError(f"ckpt-int8: {resumed.checkpointer.restores}")
    check_launches("ckpt-int8 resumed run (1 step, no calibration)", counts,
                   expected_train_launches(
                       micro=tc.grad_accum_steps,
                       eval_batches=resumed.eval_loader.steps_per_epoch,
                       layers=mc.num_layers))
    got = resumed.state.module.state_dict()
    amaxes = [k for k in want if k.endswith("amax")]
    if resumed.step_log != want_log[1:] or not amaxes or any(
            not torch.equal(got[k].cpu(), want[k]) for k in want):
        raise AssertionError(f"ckpt-int8: resumed {resumed.step_log} "
                             f"against {want_log[1:]}")
    del resumed
    res = dict(steps=want_log, amax_buffers=len(amaxes), launches=counts)
    say("[ckpt-int8] tiny, int8_full, delayed scales on both passes, resumed "
        "from step 1 with no calibration launch: step 2 and every weight and "
        "amax bit-equal: " + json.dumps(res))
    return res


def hf_gpt2_state(state: dict, cfg) -> dict:
    """The port's GPT-2 ``state_dict`` (per-layer trunk) under the HF
    ``GPT2LMHeadModel`` names and ``Conv1D`` layouts (the inverse of
    ``models/hf_loader.load_gpt2_lm``), CPU tensors."""
    import torch

    h = cfg.hidden_size
    out = {"transformer.wte.weight": state["wte.embedding"],
           "transformer.wpe.weight": state["wpe.embedding"],
           "lm_head.weight": state["wte.embedding"]}

    def norm(dst, src):
        out[dst + ".weight"] = state[src + ".scale"]
        out[dst + ".bias"] = state[src + ".bias"]

    for i in range(cfg.num_layers):
        p, q = f"blocks.{i}.", f"transformer.h.{i}."
        norm(q + "ln_1", p + "ln_1")
        qkv = ("query", "key", "value")
        out[q + "attn.c_attn.weight"] = torch.cat(
            [state[p + f"attention.{n}.kernel"].reshape(h, h) for n in qkv],
            dim=1)
        out[q + "attn.c_attn.bias"] = torch.cat(
            [state[p + f"attention.{n}.bias"].reshape(h) for n in qkv])
        out[q + "attn.c_proj.weight"] = state[
            p + "attention.out.kernel"].reshape(h, h)
        out[q + "attn.c_proj.bias"] = state[p + "attention.out.bias"]
        norm(q + "ln_2", p + "ln_2")
        for mine, theirs in (("mlp_up", "c_fc"), ("mlp_down", "c_proj")):
            out[q + f"mlp.{theirs}.weight"] = state[p + mine + ".kernel"]
            out[q + f"mlp.{theirs}.bias"] = state[p + mine + ".bias"]
    norm("transformer.ln_f", "ln_f")
    return {k: v.detach().cpu().contiguous() for k, v in out.items()}


def _generate_rows(tok, prompts):
    import numpy as np

    rows = [tok.text_ids(p) for p in prompts]
    lengths = np.asarray([len(r) for r in rows])
    ids = np.zeros((len(rows), int(lengths.max())), np.int64)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = r
    return ids, lengths


def generate_phase(ck: str, root: str, prompts=PROMPTS,
                   new_tokens=NEW_TOKENS, device="cuda") -> dict:
    """``generate_lm --checkpoint-dir`` on ckpt-resume's checkpoint
    (scanned, so re-laid out) over the serve phase's prompts, greedy; the
    library path counted (kernel 1: 2 a block + ln_f a forward, one prefill
    and ``new_tokens`` - 1 decode steps) and timed; then ``--hf-checkpoint``
    on a ``pytorch_model.bin`` of the same weights under GPT-2's HF names:
    the same streams. Returns the streams and the model for the margin
    gate."""
    import torch

    from pytorch_distributed_training_tpu_torch.cli import generate_lm
    from pytorch_distributed_training_tpu_torch.models.generate import (
        generate,
    )
    from pytorch_distributed_training_tpu_torch.models.gpt2 import unscanned
    from pytorch_distributed_training_tpu_torch.ops import _build

    pf = os.path.join(root, "prompts.txt")
    with open(pf, "w") as f:
        f.write("\n".join(prompts) + "\n")
    argv = GENERATE_ARGS + ["--checkpoint-dir", ck, "--prompt-file", pf,
                            "--max-new-tokens", str(new_tokens)]
    with contextlib.redirect_stdout(io.StringIO()):
        texts = generate_lm.main(argv)
    args = generate_lm.build_parser().parse_args(argv)
    tok = generate_lm.build_tokenizer(args)
    t0 = time.perf_counter()
    model, step = generate_lm.load_model_and_params(args, tok)
    load_s = time.perf_counter() - t0
    if step != 2 or not model.config.scan_layers:
        raise AssertionError(f"generate: step {step}, scanned "
                             f"{model.config.scan_layers}")
    model = model.to(device).eval()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flat = unscanned(model)
    torch.cuda.synchronize()
    relayout_s = time.perf_counter() - t0
    del model
    ids, lengths = _generate_rows(tok, prompts)
    width = ids.shape[1]

    def run(m, n=new_tokens):
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        out = generate(m, ids, max_new_tokens=n,
                       prompt_lengths=lengths).cpu().numpy()
        wall = time.perf_counter() - t0
        return out, wall, dict(_build.LAUNCH_COUNTS)

    out, wall, counts = run(flat)
    # the prefill, its sampling and the copy to the host alone
    _, prefill_wall, _ = run(flat, 1)
    layers = flat.config.num_layers
    check_launches(f"generate run (1 prefill, {new_tokens - 1} decode steps)",
                   counts, {"layer_norm": (2 * layers + 1) * new_tokens})
    streams = {f"r{i}": out[i, width:].tolist() for i in range(len(prompts))}
    if [tok.decode(out[i, width:]) for i in range(len(prompts))] != texts:
        raise AssertionError("generate: the CLI's texts differ from the "
                             "library's streams")
    hf = os.path.join(root, "hf")
    os.makedirs(hf)
    torch.save(hf_gpt2_state(flat.state_dict(), flat.config),
               os.path.join(hf, "pytorch_model.bin"))
    hf_args = generate_lm.build_parser().parse_args(
        GENERATE_ARGS + ["--hf-checkpoint", hf])
    hf_model, _ = generate_lm.load_model_and_params(hf_args, tok)
    hf_out, _, _ = run(hf_model.to(device).eval())
    del hf_model
    if not (hf_out == out).all():
        raise AssertionError("generate: --hf-checkpoint streams differ from "
                             "--checkpoint-dir's")
    res = dict(rows=len(prompts), new_tokens=new_tokens, launches=counts,
               wall_s=wall, prefill_wall_s=prefill_wall,
               ms_a_forward=1e3 * wall / new_tokens,
               ms_a_decode_step=1e3 * (wall - prefill_wall)
               / (new_tokens - 1),
               ms_a_token=1e3 * wall / (new_tokens * len(prompts)),
               load_s=load_s, relayout_s=relayout_s)
    say("[generate] gpt2-medium from ckpt-resume's step 2 (re-laid out), "
        f"{len(prompts)} prompts x {new_tokens} greedy tokens, dense cache; "
        "--hf-checkpoint's streams equal: " + json.dumps(res))
    return dict(res, streams=streams, model=flat)


def serve_ckpt_phase(ck: str, prompts=PROMPTS, new_tokens=NEW_TOKENS,
                     n_layers=24) -> dict:
    """``serve_lm --checkpoint-dir`` on ckpt-resume's checkpoint, counted:
    ``stats()["weights_step"]`` is 2. Returns the streams for the margin
    gate."""
    events, stats, counts, wall = serve_once(
        SERVE_CKPT_ARGS + ["--checkpoint-dir", ck], prompts, new_tokens)
    toks = streams(events, prompts, new_tokens)
    prefills, ticks = stats["admitted"], stats["decode_dispatches"]
    check_launches(
        f"serve-ckpt run ({prefills} prefills, {ticks} ticks)", counts,
        {"layer_norm": (2 * n_layers + 1) * (prefills + ticks),
         "paged_attention": n_layers * ticks})
    if stats["weights_step"] != 2:
        raise AssertionError(f"serve-ckpt: weights_step "
                             f"{stats['weights_step']}")
    res = dict(weights_step=stats["weights_step"], launches=counts,
               **serve_metrics(events, stats, wall))
    say("[serve-ckpt] serve_lm from ckpt-resume's checkpoint: "
        + json.dumps(res))
    return dict(res, streams=toks)


DRAFT_K = 4

# serve-ops: serve_lm over HTTP at gpt2-medium (the serve-ckpt shape),
# booted from a weights-only directory of its own that holds ckpt-resume's
# step 2; the swapped step adds noise of this std to every float weight
# (the random init's std is 0.02), so the greedy streams move
SERVE_OPS_ARGS = SERVE_CKPT_ARGS + [
    "--hotswap-poll-s", "0.5", "--brownout-high", "0.9", "--brownout-low",
    "0.3", "--slo-windows", "60,600", "--slo-emit-s", "1",
    "--drain-timeout-s", "60", "--stall-timeout-s", "30"]
SERVE_OPS_PERTURB = 2e-3
SERVE_OPS_LONG = 64   # the fleet SIGTERM drill: live when the signal lands


def serve_draft_phase(ck: str, prompts=PROMPTS, new_tokens=OPTION_NEW_TOKENS,
                      n_layers=24, k=DRAFT_K, argv=SERVE_CKPT_ARGS,
                      draft_model="gpt2-medium") -> dict:
    """``serve_lm --checkpoint-dir ck --spec-k 4`` on ckpt-resume's
    checkpoint with the n-gram drafter, then with ``--draft-checkpoint ck
    --draft-model gpt2-medium`` (the draft lane; the base as its own
    draft, loaded twice), each counted: the draft lane's chain of k + 1
    greedy draft decodes a verify (kernel 12 on the draft's pools, kernel
    1 in every draft forward) and its prompt mirrors beside the base
    model's launches; acceptance above 0.9; the ms a tick of each. Returns
    the streams for the margin gate."""
    base = argv + ["--checkpoint-dir", ck, "--spec-k", str(k)]
    runs = {}
    for name, flags in (("ngram", []),
                        ("draft", ["--draft-checkpoint", ck,
                                   "--draft-model", draft_model])):
        events, stats, counts, wall = serve_once(base + flags, prompts,
                                                 new_tokens)
        toks = streams(events, prompts, new_tokens)
        want = serve_option_launches(stats, n_layers)
        if name == "draft":
            # the draft's prompt mirrors (bucket prefills and chunks) and
            # its chains
            chain = (k + 1) * stats["spec_dispatches"]
            chunks = stats["prefill_chunks"]
            want["layer_norm"] += (2 * n_layers + 1) * (
                stats["prefill_dispatches"] + chunks + chain)
            want["paged_attention"] = n_layers * chain
            if chunks:
                want["paged_attention_mq"] += n_layers * chunks
        check_launches(f"serve-draft {name} run", counts, want)
        if stats["spec_draft"] != ("model" if name == "draft" else "ngram"):
            raise AssertionError(f"serve-draft {name}: stats {stats}")
        runs[name] = dict(
            serve_metrics(events, stats, wall),
            verify_dispatches=stats["spec_dispatches"],
            accept_rate=stats["spec_accept_rate"],
            tokens_per_dispatch=stats["tokens_per_dispatch"],
            weights_step=stats["weights_step"], launches=counts,
            streams=toks)
    draft = runs["draft"]
    if draft["accept_rate"] <= 0.9 or draft["weights_step"] != 2:
        raise AssertionError(f"serve-draft: {draft}")
    draft["tick_ms_vs_ngram"] = (draft["decode_tick_ms"]
                                 / runs["ngram"]["decode_tick_ms"])
    for name, m in runs.items():
        say(f"[serve-draft] {name}: " + json.dumps(
            {k: v for k, v in m.items() if k != "streams"}))
    return runs


def _http(port: int, method: str, path: str, body=None, timeout=300):
    """(status, body text) of one request to a local serve_lm."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request(method, path, body=None if body is None else json.dumps(body))
    resp = conn.getresponse()
    text = resp.read().decode()
    conn.close()
    return resp.status, text


def http_streams(port: int, prompts, new_tokens) -> dict:
    """Every prompt POSTed to ``/generate`` at once (a worker each, the
    JSONL events streamed back), as ``r<i>``; their token ids
    (``streams``: each must end ``done`` with ``new_tokens``)."""
    from concurrent.futures import ThreadPoolExecutor

    def one(i, prompt):
        status, text = _http(port, "POST", "/generate", {
            "id": f"r{i}", "prompt": prompt, "max_new_tokens": new_tokens})
        if status != 200:
            raise AssertionError(f"r{i}: HTTP {status}: {text}")
        return [json.loads(line) for line in text.splitlines()]

    with ThreadPoolExecutor(len(prompts)) as pool:
        runs = list(pool.map(one, range(len(prompts)), prompts))
    return streams([e for run in runs for e in run], prompts, new_tokens)


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def wait_ready(port: int, proc=None, timeout=300.0) -> float:
    """Poll ``/healthz`` until it answers 200; the seconds it took. Fails
    if ``proc`` (a serve_lm process) exits first."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        if proc is not None and proc.poll() is not None:
            raise AssertionError(f"serve-ops: serve_lm exited "
                                 f"{proc.returncode} before it was ready")
        try:
            if _http(port, "GET", "/healthz", timeout=5)[0] == 200:
                return time.perf_counter() - t0
        except OSError:
            pass
        time.sleep(0.2)
    raise AssertionError(f"serve-ops: port {port} never ready")


def wait_for(what: str, predicate, timeout=180.0, poll_s=0.1) -> float:
    t0 = time.perf_counter()
    while not predicate():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(poll_s)
    return time.perf_counter() - t0


def _healthz(port: int) -> dict:
    return json.loads(_http(port, "GET", "/healthz", timeout=10)[1])


def _stats(port: int) -> dict:
    return json.loads(_http(port, "GET", "/stats", timeout=30)[1])


def serve_lm_process(ops: str, root: str, name: str, extra=(), env=None):
    """``serve_lm`` over HTTP in a process of its own (``SERVE_OPS_ARGS``
    on ``ops``, its metrics under ``root/name``); (process, port, metrics
    directory). Its log goes to ``root/name.log``."""
    port, mdir = _free_port(), os.path.join(root, name)
    log = open(os.path.join(root, f"{name}.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "pytorch_distributed_training_tpu_torch.cli.serve_lm"]
        + SERVE_OPS_ARGS + ["--checkpoint-dir", ops, "--http-port",
                            str(port), "--metrics-dir", mdir,
                            "--replica-name", name, *extra],
        cwd=ROOT, env=dict(os.environ, **(env or {})),
        stdout=log, stderr=subprocess.STDOUT, text=True)
    log.close()
    return proc, port, mdir


def _log_tail(root: str, name: str) -> str:
    with open(os.path.join(root, f"{name}.log")) as f:
        return f.read()[-3000:]


def _first_ttft(mdir: str) -> float:
    reqs = [r for r in _summarize_metrics().load_records(mdir)
            if r["record"] == "serve_request"]
    return reqs[0]["ttft_s"]


def _kinds(records) -> dict:
    out = {}
    for r in records:
        out[r["record"]] = out.get(r["record"], 0) + 1
    return out


def serve_ops_int8(ops: str, w_next: dict, root: str, prompts, new_tokens,
                   n_layers=24) -> dict:
    """serve_lm with int8 weights and KV pools and chunked prefill in this
    process (its launches counted once it is ready), booted from the
    newest step of ``ops``: the prompts, then an fp32 step (``w_next``)
    published and swapped into int8, the prompts again; SIGTERM ends it
    (exit 75). Kernels 12-int8 and 13-int8 and the LayerNorm, counted
    against the engine's dispatches."""
    import signal
    from concurrent.futures import ThreadPoolExecutor

    from pytorch_distributed_training_tpu_torch.cli import serve_lm
    from pytorch_distributed_training_tpu_torch.ops import _build
    from pytorch_distributed_training_tpu_torch.serve.hotswap import (
        publish_params_checkpoint,
    )
    from pytorch_distributed_training_tpu_torch.telemetry.registry import (
        MetricsRegistry,
        set_registry,
    )

    port, mdir = _free_port(), os.path.join(root, "serve-ops-int8")
    argv = SERVE_OPS_ARGS + INT8 + [
        "--prefill-chunk", "32", "--warmup", "--checkpoint-dir", ops,
        "--http-port", str(port), "--metrics-dir", mdir]
    out, flags = {}, {"ready": False, "ended": False}

    def drive():
        try:
            t0 = time.perf_counter()
            while not flags["ended"]:
                try:
                    if _http(port, "GET", "/healthz", timeout=5)[0] == 200:
                        break
                except OSError:
                    pass
                time.sleep(0.2)
            else:
                return
            out["boot_s"] = time.perf_counter() - t0
            flags["ready"] = True
            _build.reset_launch_counts()
            boot = _healthz(port)["weights_step"]
            out["before"] = http_streams(port, prompts, new_tokens)
            out["boot_step"] = boot
            publish_params_checkpoint(ops, boot + 1, w_next)
            out["swap_wait_s"] = wait_for(
                "the int8 swap", lambda: _healthz(port)["weights_step"]
                == boot + 1)
            out["after"] = http_streams(port, prompts, new_tokens)
            out["stats"] = _stats(port)
            out["counts"] = dict(_build.LAUNCH_COUNTS)
        except Exception as e:  # raised on the main thread below
            out["error"] = e
        finally:
            if flags["ready"]:
                os.kill(os.getpid(), signal.SIGTERM)

    prev_term = signal.getsignal(signal.SIGTERM)
    prev_reg = set_registry(MetricsRegistry())
    code = 0
    with ThreadPoolExecutor(1) as pool:
        feeder = pool.submit(drive)
        try:
            serve_lm.main(argv)
        except SystemExit as e:
            code = e.code
        finally:
            flags["ended"] = True
            signal.signal(signal.SIGTERM, prev_term)
            reg = set_registry(prev_reg)
            if reg.sink is not None:
                reg.sink.close()
        feeder.result(300)
    if "error" in out:
        raise out["error"]
    stats, counts = out["stats"], out["counts"]
    check_launches(
        f"serve-ops int8 run ({stats['admitted']} requests, "
        f"{stats['prefill_chunks']} chunks, {stats['decode_dispatches']} "
        "ticks)", counts, serve_option_launches(stats, n_layers))
    # plain decode ticks and chunks both ran, so check_launches held
    # kernels 12-int8 and 13-int8 to counts above 0
    if (code != 75 or stats["variant"] != "int8" or stats["swaps"] != 1
            or not stats["prefill_chunks"] or stats["spec_dispatches"]
            or not stats["decode_dispatches"]):
        raise AssertionError(f"serve-ops int8: exit {code}, stats "
                             f"{ {k: stats[k] for k in ('variant', 'swaps')} }"
                             f", launches {counts}")
    records = _summarize_metrics().load_records(mdir)
    swap = [r for r in records if r["record"] == "swap_applied"]
    return dict(boot_s=out["boot_s"], boot_step=out["boot_step"],
                swap_wait_s=out["swap_wait_s"], launches=counts,
                published_variant=swap[0]["variant"], exit=code,
                weights_step=stats["weights_step"],
                before=out["before"], after=out["after"])


def _margin_model(state: dict, weights: str, device,
                  model_name="gpt2-medium"):
    """``model_name`` on ``state`` (reference attention, float32), cast
    for serving as an engine of ``weights`` casts it, for
    ``margin_check``."""
    from pytorch_distributed_training_tpu_torch.models.gpt2 import (
        GPT2LMModel,
        unscanned,
    )
    from pytorch_distributed_training_tpu_torch.models.relayout import (
        has_scanned_trunk,
    )
    from pytorch_distributed_training_tpu_torch.utils.config import (
        model_preset,
    )

    model = GPT2LMModel(model_preset(
        model_name, attention_impl="reference",
        scan_layers=has_scanned_trunk(state)), device="meta")
    model.load_state_dict(state, assign=True)
    model = unscanned(model).to(device)
    model.cast_for_serving(weights)
    return model.eval()


def serve_ops_start(ck: str, root: str) -> dict:
    """ckpt-resume's step 2 published weights-only into ``root/ops``
    (``publish_params_checkpoint``), then a serve_lm process started on
    it (``serve_lm_process``) with ``--warmup``, ``--hotswap-poll-s``,
    ``--metrics-dir``, the brownout and SLO flags and
    ``PDT_TPU_FAULT=corrupt_ckpt_swap:4``. It boots while this process
    runs the checkpoint block's checks; ``serve_ops_phase`` drives it.
    The first TTFT without ``--warmup`` and the SIGTERM drill of a live
    stream are the fleet phase's (its replicas run without it)."""
    from pytorch_distributed_training_tpu_torch.serve.hotswap import (
        publish_params_checkpoint,
    )
    from pytorch_distributed_training_tpu_torch.train import checkpoint

    ops = os.path.join(root, "ops")
    w2 = checkpoint.restore_params(ck, step=2)
    t0 = time.perf_counter()
    publish_params_checkpoint(ops, 2, w2)
    publish_s = time.perf_counter() - t0
    return dict(
        ops=ops, w2=w2, publish_s=publish_s,
        warm=serve_lm_process(ops, root, "serve-ops", ["--warmup"],
                              env={"PDT_TPU_FAULT": "corrupt_ckpt_swap:4"}))


def serve_ops_phase(started: dict, root: str, device, prompts=PROMPTS,
                    new_tokens=OPTION_NEW_TOKENS,
                    model_name="gpt2-medium") -> dict:
    """The serving support layers at gpt2-medium's full width, over HTTP,
    on the serve_lm process of ``serve_ops_start``: its first TTFT (the
    request alone on the card), the prompts streamed, a perturbed step 3
    published and swapped in (the swap's load and apply seconds from its
    ``swap_ok`` record), the prompts again, a step 4 whose load fails
    (refused before a byte is read, so a one-tensor step: the streams
    stay), ``/healthz`` and ``/debug/flight``, SIGTERM (exit 75); then
    step 4 removed and ``serve_ops_int8`` (booted on step 3). Every
    stream against a full-sequence forward of the weights that served
    it, at MARGIN_TOL (INT8_KV_MARGIN_TOL on int8 pools)."""
    import signal

    import torch

    from pytorch_distributed_training_tpu_torch.serve.hotswap import (
        publish_params_checkpoint,
    )
    from pytorch_distributed_training_tpu_torch.train import checkpoint

    ops, w2, name = started["ops"], started["w2"], "serve-ops"
    proc, port, mdir = started["warm"]
    try:
        g = torch.Generator().manual_seed(3)
        w3 = {k: v + SERVE_OPS_PERTURB * torch.randn(v.shape, generator=g)
              if v.is_floating_point() else v for k, v in w2.items()}
        wait_ready(port, proc)
        http_streams(port, prompts[:1], new_tokens)
        ttft = _first_ttft(mdir)
        before = http_streams(port, prompts, new_tokens)
        publish_params_checkpoint(ops, 3, w3)
        swap_wait = wait_for("the swap to step 3", lambda: _healthz(port)[
            "weights_step"] == 3)
        after = http_streams(port, prompts, new_tokens)
        publish_params_checkpoint(ops, 4, {"wte.embedding": w2[
            "wte.embedding"][:1]})
        wait_for("the refused step 4", lambda: _stats(port)[
            "swap_failures"] == 1)
        refused = http_streams(port, prompts, new_tokens)
        health = _healthz(port)
        fstatus, ftext = _http(port, "GET", "/debug/flight")
        flight = json.loads(ftext)
        stats = _stats(port)
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
    shutil.rmtree(checkpoint.step_path(ops, 4))
    records = _summarize_metrics().load_records(mdir)
    kinds = _kinds(records)
    ok = [r for r in records if r["record"] == "swap_ok"]
    failed = [r for r in records if r["record"] == "swap_failed"]
    if (code != 75 or refused != after or before == after
            or health["state"] != "ready" or health["weights_step"] != 3
            or fstatus != 200 or not flight["entries"]
            or stats["swaps"] != 1 or len(ok) != 1
            or [(r["version"], r["stage"]) for r in failed] != [(4, "load")]
            or "slo_burn" not in kinds or "span" not in kinds):
        raise AssertionError(
            f"serve-ops: exit {code}, refused==after {refused == after}, "
            f"health {health}, flight {fstatus}, swaps {stats['swaps']}, "
            f"swap_ok {ok}, swap_failed {failed}, records {kinds}: "
            + _log_tail(root, name))
    res = dict(
        publish_s=started["publish_s"],
        first_ttft_s={"warmup": ttft},
        swap=dict(load_s=ok[0]["load_s"], total_s=ok[0]["total_s"],
                  apply_s=ok[0]["total_s"] - ok[0]["load_s"],
                  wait_s=swap_wait),
        refused=dict(version=4, stage="load", streams_unchanged=True),
        flight_entries=len(flight["entries"]), exit=code,
        records=kinds)
    say("[serve-ops] serve_lm --http-port --warmup --hotswap-poll-s "
        "--metrics-dir, gpt2-medium from a checkpoint: " + json.dumps(res))
    int8 = serve_ops_int8(ops, w2, root, prompts, new_tokens)
    res["int8"] = {k: v for k, v in int8.items()
                   if k not in ("before", "after")}
    say("[serve-ops] int8 weights and KV, an fp32 step swapped in: "
        + json.dumps(res["int8"]))
    margins = {}
    for state, runs in ((w2, (("float32", "serve-ops-before", before),
                              ("int8", "serve-ops-int8-after",
                               int8["after"]))),
                        (w3, (("float32", "serve-ops-after", after),
                              ("int8", "serve-ops-int8-before",
                               int8["before"])))):
        for weights, tag, toks in runs:
            tol = INT8_KV_MARGIN_TOL if weights == "int8" else MARGIN_TOL
            model = _margin_model(state, weights, device, model_name)
            margins[tag] = margin_check(model, tag, toks, prompts, tol,
                                        device, weights=weights)
            del model
            _free_cuda()
    res["margins"] = margins
    return res


# the fleet phase: fleet_lm over two replicas at the serve phase's shape
# (SERVE_ARGS: 8 slots, buckets 16-128, page 16, seed 0). One prompt goes
# to each replica first (round robin on equal loads); replica 1 dies
# after that first busy tick, its request mid-stream (an explicit
# retryable error, or a failover if no byte was out). Its
# ``fault_injected`` record is flushed before it exits, and the other
# ten go out the moment it shows: the router still holds replica 1's
# breaker closed and its last health sample (taken during its first
# prefill: no load), so it sends it requests that no live engine admits;
# they fail before a byte and go over to replica 0 (failovers)
FLEET_ARGS = ["--replicas", "2", *SERVE_ARGS, "--page-size", "16"]
FLEET_FAULT = "replica_crash:1@1"


def fleet_start(root: str) -> dict:
    """``fleet_lm`` (``FLEET_ARGS``, ``PDT_TPU_FAULT=FLEET_FAULT``) in a
    process of its own, its router on a free port and its metrics under
    ``root/fleet``; a thread polls the router's ``/stats`` and notes the
    wall time each replica first reports ready (its boot ends there).
    The replicas boot while this process runs phases that time nothing;
    ``fleet_phase`` drives them."""
    from concurrent.futures import ThreadPoolExecutor

    port, mdir = _free_port(), os.path.join(root, "fleet")
    log = open(os.path.join(root, "fleet.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "pytorch_distributed_training_tpu_torch.cli.fleet_lm", *FLEET_ARGS,
         "--router-port", str(port), "--metrics-dir", mdir],
        cwd=ROOT, env=dict(os.environ, PDT_TPU_FAULT=FLEET_FAULT),
        stdout=log, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)   # its replicas share its process group
    log.close()
    ready, stop = {}, []     # ``stop`` non-empty ends the poll

    def poll():
        while not stop and proc.poll() is None:
            time.sleep(0.1)
            try:
                view = json.loads(_http(port, "GET", "/stats", timeout=5)[1])
            except (OSError, ValueError):
                continue
            for r in view["replicas"]:
                if r["health"].get("state") == "ready":
                    ready.setdefault(r["name"], time.time())
            if len(ready) == 2:
                return

    pool = ThreadPoolExecutor(1, thread_name_prefix="fleet-boot")
    pool.submit(poll)
    pool.shutdown(wait=False)
    return dict(proc=proc, port=port, mdir=mdir, ready=ready, stop=stop)


def _fleet_records(mdir: str) -> list:
    """The records of ``mdir``'s stream so far (a line still being
    written is skipped; the fleet polls this while replicas write)."""
    path = os.path.join(mdir, "metrics.jsonl")
    if not os.path.exists(path):
        return []
    records = []
    with open(path) as f:
        for line in f:
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                pass
    return records


def _fleet_request(port: int, i: int, prompt: str, new_tokens: int) -> dict:
    """One greedy request through the router; its outcome (``done``,
    ``retryable`` or ``bad``), token ids and client-side TTFT."""
    import http.client

    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request("POST", "/generate", body=json.dumps(
        {"id": f"r{i}", "prompt": prompt, "max_new_tokens": new_tokens}))
    resp = conn.getresponse()
    events, ttft = [], None
    while True:
        line = resp.readline()
        if not line:
            break
        events.append(json.loads(line))
        if ttft is None and events[-1]["event"] == "token":
            ttft = time.perf_counter() - t0
    conn.close()
    last = events[-1] if events else {}
    if resp.status == 200 and last.get("event") == "done" and (
            last.get("status") == "done"):
        outcome = "done"
    elif last.get("event") == "error" and last.get("retryable"):
        outcome = "retryable"
    else:
        outcome = "bad"
    return dict(outcome=outcome, status=resp.status, ttft_s=ttft,
                tokens=[e["token_id"] for e in events
                        if e["event"] == "token"], last=last)


def fleet_phase(started: dict, plain: dict, serve_ttft_p50_s: float,
                prompts=PROMPTS, new_tokens=NEW_TOKENS) -> dict:
    """The serving fleet on the card (``fleet_start``'s ``fleet_lm``): its
    replicas' boot seconds; the 12 prompts through the router, one a
    replica first, then the rest (see ``FLEET_FAULT``), while
    ``FLEET_FAULT`` kills replica 1 — every request ends ``done`` or
    with an explicit retryable error, none hangs, every
    ``done`` stream equals the serve phase's (``plain``: same seed and
    weights) token for token, replica 1 exited 23 and the router failed
    over at least once. TTFT p50 through the router (client side) beside
    the serve phase's, and requests/s. Replica 1 respawns while later
    phases that time nothing run; ``fleet_finish`` reads the recovery."""
    from concurrent.futures import ThreadPoolExecutor

    proc, port, mdir = started["proc"], started["port"], started["mdir"]
    wait_for("the fleet's two replicas", lambda: len(
        started["ready"]) == 2 or proc.poll() is not None, timeout=600)
    if proc.poll() is not None:
        raise AssertionError(f"fleet_lm exited {proc.returncode}")
    spawn = {r["replica"]: r["ts"] for r in _fleet_records(mdir)
             if r["record"] == "replica_spawn"}
    boot = {name: t - spawn[name]
            for name, t in sorted(started["ready"].items())}

    def picks() -> list:
        return [r["requests"] for r in json.loads(
            _http(port, "GET", "/stats")[1])["replicas"]]

    def r1_crashed() -> bool:
        return any(r.get("fault") == "replica_crash" for r in
                   _fleet_records(os.path.join(mdir, "replica-1")))

    t0 = time.perf_counter()
    pool = ThreadPoolExecutor(len(prompts))
    futs = []
    while min(picks()) < 1:
        if len(futs) == 4:
            raise AssertionError(f"fleet: picks {picks()} after 4 requests")
        futs.append(pool.submit(_fleet_request, port, len(futs),
                                prompts[len(futs)], new_tokens))
        wait_for("the router's pick", lambda: sum(picks()) >= len(futs),
                 timeout=60, poll_s=0.01)
    wait_for("replica 1's crash", r1_crashed, timeout=300, poll_s=0.01)
    futs += [pool.submit(_fleet_request, port, i, p, new_tokens)
             for i, p in enumerate(prompts) if i >= len(futs)]
    outs = [f.result(timeout=600) for f in futs]
    pool.shutdown()
    wave_s = time.perf_counter() - t0
    view = json.loads(_http(port, "GET", "/stats")[1])
    done = [i for i, o in enumerate(outs) if o["outcome"] == "done"]
    bad = [(i, o["status"], o["last"]) for i, o in enumerate(outs)
           if o["outcome"] == "bad"]
    differ = [i for i in done if outs[i]["tokens"] != plain[f"r{i}"]]
    records = _fleet_records(mdir)
    crash = [r for r in records if r["record"] == "replica_exit"]
    if (bad or differ or not done or view["failovers"] < 1
            or [(r["replica"], r["rc"]) for r in crash] != [("r1", 23)]):
        timeline = [(round(r["ts"] - records[0]["ts"], 3), r["record"],
                     r.get("id"), r.get("replica"), r.get("attempts"),
                     r.get("status"), r.get("to"))
                    for r in records if r["record"] in (
                        "router_request", "router_failover",
                        "router_breaker", "replica_exit")]
        raise AssertionError(
            f"fleet: bad {bad}, streams differing {differ}, done {done}, "
            f"router {view}, exits {crash}, timeline {timeline}: "
            + _log_tail(os.path.dirname(mdir), "fleet"))
    ttft = [outs[i]["ttft_s"] for i in done]
    res = dict(
        replicas=2, requests=len(prompts), new_tokens=new_tokens,
        fault=FLEET_FAULT, boot_s=boot,
        done=len(done), retryable_errors=len(prompts) - len(done),
        availability=len(done) / len(prompts),
        failovers=view["failovers"], streams_equal_serve=len(done),
        ttft_p50_s=statistics.median(ttft), ttft_max_s=max(ttft),
        serve_ttft_p50_s=serve_ttft_p50_s, wave_s=wave_s,
        requests_per_s=len(done) / wave_s)
    say("[fleet] fleet_lm --replicas 2, gpt2-medium at the serve phase's "
        "shape, replica 1 killed mid-load: " + json.dumps(res))
    return dict(res, crash_ts=crash[0]["ts"])


def fleet_kill(started, root: str) -> None:
    """Stop what ``fleet_start`` started, if anything still runs (a phase
    failed between it and ``fleet_finish``): SIGTERM drains the fleet,
    then its process group (``fleet_lm`` and every replica) is killed;
    ``root`` removed."""
    import signal

    if started is not None:
        proc = started["proc"]
        started["stop"].append(True)
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(60)
            except subprocess.TimeoutExpired:
                pass
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait(30)
    shutil.rmtree(root, ignore_errors=True)


def fleet_finish(started: dict, wave: dict, prompts=PROMPTS) -> dict:
    """After ``fleet_phase``: replica 1 respawned with one restart burned
    and the pool back to 2 up (seconds from its exit, the respawn's boot
    beside phases that time nothing); then a ``SERVE_OPS_LONG``-token
    stream straight to replica 0 (the respawned replica 1 carries the
    fault again) and, once its first token is out, SIGTERM to
    ``fleet_lm``: the stream still ends ``done``, ``fleet_lm`` exits 0,
    each replica leaves with 75 after a ``sigterm_drain`` flight dump
    and a ``preemption`` record, and the fleet's stream ends with its
    ``fleet_summary``. Replica 0's first request (no ``--warmup``) gives
    the first TTFT without it."""
    import signal
    from concurrent.futures import ThreadPoolExecutor

    proc, port, mdir = started["proc"], started["port"], started["mdir"]
    wait_for("replica 1's respawn", lambda: json.loads(_http(
        port, "GET", "/stats")[1])["available"] == 2, timeout=600)
    recovered_t = time.time()
    view = json.loads(_http(port, "GET", "/stats")[1])
    r0_port = view["replicas"][0]["port"]
    events = []

    def stream():
        import http.client

        conn = http.client.HTTPConnection("127.0.0.1", r0_port, timeout=300)
        conn.request("POST", "/generate", body=json.dumps({
            "id": "long", "prompt": prompts[2],
            "max_new_tokens": SERVE_OPS_LONG}))
        resp = conn.getresponse()
        while True:
            line = resp.readline()
            if not line:
                break
            events.append(json.loads(line))
        conn.close()
        return resp.status

    pool = ThreadPoolExecutor(1, thread_name_prefix="fleet-long")
    client = pool.submit(stream)
    wait_for("the long stream's first token",
             lambda: events or client.done(), timeout=300, poll_s=0.01)
    proc.send_signal(signal.SIGTERM)
    code = proc.wait(300)
    long = dict(status=client.result(timeout=300), events=events)
    pool.shutdown()
    records = _fleet_records(mdir)
    exits = sorted((r["replica"], r["rc"]) for r in records
                   if r["record"] == "replica_exit")
    budget = view["pool"]["restart_budget_remaining"]
    summary = [r for r in records if r["record"] == "fleet_summary"]
    drains, first_ttft = {}, None
    for name in ("r0", "r1"):
        rec = _fleet_records(os.path.join(mdir, f"replica-{name[1:]}"))
        drains[name] = dict(
            dumps=[r["reason"] for r in rec if r["record"] == "flight_dump"],
            preemption=any(r["record"] == "preemption" for r in rec))
        if name == "r0":
            first_ttft = next(r["ttft_s"] for r in rec
                              if r["record"] == "serve_request")
    done = long.get("events", [{}])[-1]
    if (view["pool"]["up"] != 2 or budget["r1"] != budget["r0"] - 1
            or code != 0 or exits != [("r0", 75), ("r1", 23), ("r1", 75)]
            or not summary or long.get("status") != 200
            or done.get("event") != "done"
            or done.get("new_tokens") != SERVE_OPS_LONG
            or any(d["dumps"] != ["sigterm_drain"] or not d["preemption"]
                   for d in drains.values())):
        raise AssertionError(
            f"fleet: router {view}, exits {exits}, fleet_lm exit {code}, "
            f"summary {bool(summary)}, the long stream's last event "
            f"{done}, drains {drains}: "
            + _log_tail(os.path.dirname(mdir), "fleet"))
    res = dict(recovery_s=recovered_t - wave["crash_ts"],
               restarts_used={"r1": budget["r0"] - budget["r1"]},
               pool_up=view["pool"]["up"], exits=exits, fleet_lm_exit=code,
               drained_tokens=done["new_tokens"], drains=drains,
               first_ttft_no_warmup_s=first_ttft)
    say("[fleet] replica 1 respawned, the pool back to 2 up, then SIGTERM "
        "during a stream: " + json.dumps(res))
    return res


def ckpt_margin_phase(gen: dict, serve: dict, device, prompts=PROMPTS,
                      extra=None) -> dict:
    """Every generated and served token of the checkpoint's weights
    against a full-sequence forward (reference attention) of them;
    ``extra``: more runs' streams on ``prompts`` (name -> streams)."""
    import dataclasses

    from pytorch_distributed_training_tpu_torch.models.gpt2 import (
        GPT2LMModel,
    )

    flat = gen.pop("model")
    check = GPT2LMModel(dataclasses.replace(flat.config,
                                            attention_impl="reference"),
                        device="meta")
    check.load_state_dict(flat.state_dict(), assign=True)
    check.cast_for_serving("float32")
    check.eval()
    del flat
    runs = dict(generate=gen["streams"], **{"serve-ckpt": serve["streams"]},
                **(extra or {}))
    gen.pop("streams")
    serve.pop("streams")
    out = {name: margin_check(check, name, toks, prompts, MARGIN_TOL, device)
           for name, toks in runs.items()}
    del check
    _free_cuda()
    return out


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
        say(f"[time] {name}: {laps[name]} s")

    smi = device_phase()
    build_phase()
    lap("build")
    res = {"layer_norm": layer_norm_phase(device),
           "paged_attention": paged_phase(device),
           "layer_norm_bwd": ln_bwd_phase(device)}
    res["mask_scale"], res["mask_scale_apply"] = mask_scale_phase(device)
    res["dropout_add_layer_norm"], res["dropout_add_layer_norm_bwd"] = (
        dal_phase(device))
    lap("kernels")
    res.update(dropout_modes_phase(device))
    lap("dropout-modes")
    res["paged_attention_mq"] = paged_mq_phase(device)
    res["paged_attention_int8"], res["paged_attention_mq_int8"] = (
        paged_int8_phase(device))
    res.update(flash_phase(device))
    res.update(two_pass_phase(device))
    lap("flash kernels")
    int8_gemm_phase(device)
    lap("int8-gemm")
    train = train_phase()
    lap("train")
    int8_root = tempfile.mkdtemp(prefix="pdt_chip_smoke_")
    try:
        int8 = train_int8_phase(int8_root)
    finally:
        shutil.rmtree(int8_root, ignore_errors=True)
    lap("train-int8")
    train_options_phase(int8["native"])
    lap("train-options")
    train_profile_phase(train["warm"], one_step(TRAIN_ARGS))
    lap("train-profile")
    roberta = roberta_mnli_phase()
    lap("roberta-mnli")
    streams = dropout_streams_phase()
    lap("dropout-streams")
    tel_root = tempfile.mkdtemp(prefix="pdt_chip_smoke_")
    try:
        telemetry_faults_phase(tel_root, roberta["warm"])
    finally:
        shutil.rmtree(tel_root, ignore_errors=True)
    lap("telemetry-faults")
    train_phase(TRAIN_MP_ARGS, "train_mp", tag="train-mp")
    lap("train-mp")
    cpu_vs_card_phase()
    cpu_vs_card_phase(TINY_MP_ARGS, "train_mp")
    stage_phase()
    lap("cpu-vs-card + stage")
    train_pipeline_phase()
    lap("train-pipeline")
    lm = lm_phase(LM_1024_ARGS, steps=3, rerun=True, tag="lm-1024")
    lap("lm-1024")
    train_profile_phase(lm["warm"],
                        one_step(LM_1024_ARGS, LM_PROFILE_TRAIN_SIZE),
                        "train_lm", tag="lm-1024-profile",
                        forbid=FMA_FLASH_SYMBOLS)
    lap("lm-1024-profile")
    two_pass = two_pass_lm_phase(lm)
    train_profile_phase(None, one_step(LM_1024_ARGS, LM_PROFILE_TRAIN_SIZE),
                        "train_lm", tag="lm-1024-two-pass-profile",
                        env={"PDT_FLASH_TWO_PASS": "1"},
                        forbid=FMA_FLASH_SYMBOLS)
    lap("lm-1024-two-pass")
    lm_short = lm_phase(LM_128_ARGS, steps=1, rerun=False, tag="lm-128")
    train_profile_phase(None, LM_128_ARGS, "train_lm",
                        tag="lm-128-profile", forbid=FMA_FLASH_SYMBOLS)
    cpu_vs_card_phase(TINY_LM_ARGS, "train_lm")
    lap("lm-128 + cpu-vs-card")
    lm_phase(LM_INT8_ARGS, steps=1, rerun=False, tag="lm-1024-int8")
    cpu_vs_card_phase(TINY_INT8_ARGS, rtol=INT8_CPU_CARD_RTOL)
    lap("lm-1024-int8 + cpu-vs-card-int8")
    lm_scan_equal_phase()
    lap("lm-scan-equal")
    # three phases in processes of their own side by side: lm-fsdp, the
    # serve-tp pair (read after the serve options) and mp-cp's pair
    fsdp, serve_tp_procs = lm_fsdp_start(), serve_tp_start()
    mp_cp_phase()
    lm_fsdp_phase(fsdp)
    lap("lm-fsdp + mp-cp (+ serve-tp started)")
    remat_phase()
    lap("remat")
    tp_split_phase(device)
    lap("tp-split")
    ring_phase(device)
    lap("ring")
    tp_cp_equal_phase()
    lap("tp-cp-equal")
    serve_tp_block_phase(device)
    lap("serve-tp-block")
    serve = serve_phase()
    plain = serve.pop("streams")
    profile_phase(serve["warm"])
    lap("serve")
    options = serve_options_phase(plain)
    tick_phase()
    lap("serve options")
    serve_tp = serve_tp_phase(serve_tp_procs, plain,
                              options["int8"]["streams"])
    lap("serve-tp")
    dense_host = serve_dense_host_phase(plain)
    lap("serve-dense-host")
    tenant = serve_tenant_phase()
    lap("serve-tenant")
    root = tempfile.mkdtemp(prefix="pdt_chip_smoke_")
    fleet_root = tempfile.mkdtemp(prefix="pdt_chip_smoke_")
    fleet_started = None
    try:
        resume = ckpt_resume_phase(root)
        lap("ckpt-resume")
        ckpt_int8_phase(root)
        lap("ckpt-int8")
        gen = generate_phase(resume["dir"], root)
        lap("generate")
        serve_ckpt = serve_ckpt_phase(resume["dir"])
        lap("serve-ckpt")
        draft = serve_draft_phase(resume["dir"])
        lap("serve-draft")
        # serve-ops' two serve_lm processes and the fleet's two replicas
        # boot during the checks, which time nothing
        started = serve_ops_start(resume["dir"], root)
        fleet_started = fleet_start(fleet_root)
        ckpt_margin_phase(gen, serve_ckpt, device, extra={
            f"serve-draft-{name}": run.pop("streams")
            for name, run in draft.items()})
        ckpt_fallback_phase(resume)
        lap("ckpt checks")
        ops = serve_ops_phase(started, root, device)
        lap("serve-ops")
        # the fleet's replica 1 respawns during the full-sequence checks
        fleet = fleet_phase(fleet_started, plain, serve["warm"]["ttft_p50_s"])
        lap("fleet")
    except BaseException:
        fleet_kill(fleet_started, fleet_root)
        raise
    finally:
        shutil.rmtree(root, ignore_errors=True)
    checks = {"serve": (plain, PROMPTS, "float32", MARGIN_TOL),
              "serve-dense-host": (dense_host.pop("streams"), PROMPTS,
                                   "float32", MARGIN_TOL),
              "serve-tenant": (tenant.pop("streams"), tenant.pop("prompts"),
                               "float32", MARGIN_TOL)}
    for k, v in options.items():
        int8_kv = v["kv_dtype"] == "int8"
        checks[f"serve-{k}"] = (
            v.pop("streams"), v.pop("prompts"),
            "int8" if v["variant"] == "int8" else "float32",
            INT8_KV_MARGIN_TOL if int8_kv else MARGIN_TOL)
    for name, v in serve_tp.items():
        int8 = name.endswith("int8")
        checks[name] = (v.pop("streams"), OPTION_PROMPTS,
                        "int8" if int8 else "float32",
                        INT8_KV_MARGIN_TOL if int8 else MARGIN_TOL)
    try:
        full_sequence_phase(device, checks, sampled=[
            (f"serve-sampled-{name}", toks, SAMPLED_REQUEST["prompt"],
             SAMPLED_REQUEST)
            for name, toks in dense_host["sampled"].items()])
        lap("full-sequence checks")
        fleet_finish(fleet_started, fleet)
    finally:
        fleet_kill(fleet_started, fleet_root)
    lap("fleet recovery")
    say("[done] seconds by phase " + json.dumps(laps))

    kernels = []
    # each kernel's launches from the main path that runs it
    runs = dict(paged_attention=serve, flash_fwd=lm, flash_bwd=lm,
                flash_whole_fwd=lm_short, flash_whole_bwd=lm_short,
                paged_attention_mq=options["spec"], flash_dq=two_pass,
                flash_dkv=two_pass, paged_attention_int8=options["int8"],
                paged_attention_mq_int8=options["int8-spec"],
                dropout_bits8=streams["bits8"], dropout_exact=streams["exact"])
    for name in _build.KERNELS:
        r = res[name]
        launches = runs.get(name, train)["launches"].get(name, 0)
        if name in ("paged_attention_int8", "paged_attention_mq_int8"):
            # serve-ops' int8 server, swapped into, runs both too
            launches = max(launches, ops["int8"]["launches"].get(name, 0))
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
