#!/usr/bin/env python3
"""Time the port's paged attention kernels (kernel 12, the single-query
decode, and kernel 13, the multi-query block, each on float and int8
pools) from several source trees in turns, on one CUDA card.

    python3 scripts/paged_ab.py OLD_TREE NEW_TREE [MORE_TREES ...]

Each TREE is the root of a checkout of this repository (for the parent
commit: ``git archive <commit> | tar -x -C _archive/parent``). The trees
run forward and then backward (old, new, new, old), each in a process of
its own that builds that tree's ``csrc/paged_attention.cu`` and
``csrc/paged_attention_mq.cu`` and times them with ``chip_smoke.py``'s
CUDA-graph timer (``time_ms``), 16 heads of 64, bf16 q, on bf16 pools and
on int8 pools, beside SDPA on the K/V gathered (and, for int8, dequantized
to bf16) beforehand with the causal-horizon mask: kernel 12 at the serve
decode tick (8 sequences of ``SERVE_CONTEXTS`` tokens, W
``SERVE_WINDOWS``) and at the parity shape (``PAGED_LENGTHS``, W 64);
kernel 13 at the verify shape (``VERIFY_Q`` rows over ``SERVE_CONTEXTS``
+ ``VERIFY_Q`` tokens, W ``VERIFY_WINDOWS``) and at the chunk shape
(``CHUNK_Q`` rows of one sequence of each ``CHUNK_CONTEXTS`` length, W
``SERVE_WINDOWS``). The timing code and inputs are this script's and this
repository's ``chip_smoke.py``; only the kernels come from the tree.
Prints the card's name and power limit, one JSON line a run, and last a
JSON summary: each tree's times, min..max over its runs.
"""

from __future__ import annotations

import functools
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_one(tree: str) -> dict:
    """Build ``tree``'s paged kernels and time them (this process only)."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    import torch.nn.functional as F

    from pytorch_distributed_training_tpu_torch.ops import _build
    from pytorch_distributed_training_tpu_torch.ops.paged_attention import (
        paged_attention,
    )
    from pytorch_distributed_training_tpu_torch.ops.quant import quantize_kv

    c = _chip_smoke()
    if not torch.cuda.is_available():
        raise SystemExit("paged_ab: no CUDA GPU visible")
    _build.build(["paged_attention", "paged_attention_mq"])
    device = torch.device("cuda")
    geo = c.PAGED
    scale = geo["head_dim"] ** -0.5
    verify = tuple(n + c.VERIFY_Q for n in c.SERVE_CONTEXTS)
    shapes = [("serve", c.SERVE_CONTEXTS, None, c.SERVE_WINDOWS),
              ("parity", c.PAGED_LENGTHS, None,
               -(-max(c.PAGED_LENGTHS) // geo["page_size"])),
              ("verify", verify, c.VERIFY_Q, c.VERIFY_WINDOWS)]
    shapes += [(f"chunk {n}", (n,), c.CHUNK_Q, c.SERVE_WINDOWS)
               for n in c.CHUNK_CONTEXTS]
    res = {}
    for shape, lens_list, q_len, w in shapes:
        q, kp, vp, bt, lens = c.paged_inputs(device, lens_list, windows=w,
                                             q_len=q_len, seed=1, **geo)
        idx = bt.long()
        b, h, d = q.shape[0], q.shape[-2], q.shape[-1]
        rows = 1 if q_len is None else q_len
        limit = (lens[:, None] - (rows - 1)
                 + torch.arange(rows, device=device)[None])
        mask = (torch.arange(idx.shape[1] * geo["page_size"], device=device)
                [None, None] < limit[:, :, None])[:, None]
        q4 = (q[:, :, None] if q_len is None
              else q.transpose(1, 2).contiguous())

        def gathered(pages, sc=None):   # [B, H, T, D] bf16
            x = pages[idx]
            if sc is not None:
                x = x.float() * sc[idx][..., None]
            return (x.reshape(b, -1, h, d).transpose(1, 2).contiguous()
                    .bfloat16())

        (kq, ks), (vq, vs) = quantize_kv(kp.float()), quantize_kv(vp.float())
        kernel = 12 if q_len is None else 13
        for pools, kern, kg, vg in (
                ("bf16", functools.partial(paged_attention, q, kp, vp, bt,
                                           lens, scale=scale),
                 gathered(kp), gathered(vp)),
                ("int8", functools.partial(paged_attention, q, kq, vq, bt,
                                           lens, scale=scale, k_scales=ks,
                                           v_scales=vs),
                 gathered(kq, ks), gathered(vq, vs))):
            res[f"{kernel} {pools} {shape}"] = dict(
                ms=c.time_ms(kern),
                library_ms=c.time_ms(lambda: F.scaled_dot_product_attention(
                    q4, kg, vg, attn_mask=mask, scale=scale)),
                bound_ms=c.paged_bound(lens_list, q_len=rows,
                                       int8=pools == "int8", **geo)[0])
    return res


def main(argv) -> int:
    if len(argv) >= 2 and argv[0] == "--one":
        print(json.dumps(run_one(argv[1])), flush=True)
        return 0
    trees = argv
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[paged-ab] {smi}", flush=True)
    runs = {t: [] for t in trees}
    for tree in trees + trees[::-1]:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", tree],
            capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            print(out.stdout[-4000:] + out.stderr[-8000:], file=sys.stderr)
            return 1
        res = json.loads(out.stdout.strip().splitlines()[-1])
        runs[tree].append(res)
        print(f"[paged-ab] {tree}: " + json.dumps(res), flush=True)
    summary = {
        tree: {key: {m: [min(r[key][m] for r in rs), max(r[key][m]
                                                         for r in rs)]
                     for m in rs[0][key]}
               for key in rs[0]}
        for tree, rs in runs.items()}
    print(json.dumps({"device": smi, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
