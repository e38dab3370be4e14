#!/usr/bin/env python3
"""Time the port's LayerNorm kernels (kernel 1, the forward, and kernel 2,
the backward) and its dropout-add-LayerNorm kernels (kernel 3, the
forward, and kernel 4, the backward) from several source trees in turns,
on one CUDA card.

    python3 scripts/ln_ab.py OLD_TREE NEW_TREE [MORE_TREES ...]

Each TREE is the root of a checkout of this repository (for the parent
commit: ``git archive <commit> | tar -x -C _archive/parent``). The trees
run forward and then backward (old, new, new, old), each in a process of
its own that builds that tree's ``csrc/layer_norm.cu`` and
``csrc/dropout_add_layer_norm.cu`` and times them with ``chip_smoke.py``'s
CUDA-graph timer (``time_ms``) at H 1024, bf16: kernel 1 (bf16 out) at
``FWD_ROWS`` rows beside ``F.layer_norm`` (bf16 scale and bias), kernel 2
at ``BWD_ROWS`` rows beside ``native_layer_norm_backward`` (all three
gradients), kernels 3 and 4 at ``DAL_ROWS`` rows (rate 0.1, s saved: the
training tails) and kernel 3 at ``DAL_EVAL_ROWS`` rows (rate 0, no s: the
eval forward). The timing code and
inputs are this script's and this repository's ``chip_smoke.py``; only the
kernels come from the tree. Prints the card's name and power limit, one
JSON line a run, and last a JSON summary: each tree's times, min..max over
its runs.
"""

from __future__ import annotations

import functools
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# serve's decode tick (8 slots), a prefill, BERT and lm-128's 1024 rows
# (8 x 128), lm-1024's 4096 (4 x 1024)
FWD_ROWS = (8, 128, 1024, 4096)
BWD_ROWS = (1024, 4096)
# BERT's training tails (8 x 128) and eval forward (32 x 128)
DAL_ROWS = 1024
DAL_EVAL_ROWS = 4096
HIDDEN = 1024


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_one(tree: str) -> dict:
    """Build ``tree``'s LayerNorm kernels and time them (this process
    only)."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    import torch.nn.functional as F

    from pytorch_distributed_training_tpu_torch.ops import _build
    from pytorch_distributed_training_tpu_torch.ops.layer_norm import (
        _dal_bwd_cuda,
        _dal_fwd_cuda,
        layer_norm,
    )

    c = _chip_smoke()
    if not torch.cuda.is_available():
        raise SystemExit("ln_ab: no CUDA GPU visible")
    _build.build(["layer_norm", "dropout_add_layer_norm"])
    device = torch.device("cuda")
    g = torch.Generator(device=device).manual_seed(0)
    res = {}
    for rows in FWD_ROWS:
        x, _, scale, bias = c._ln_train_inputs(g, rows, HIDDEN, device)
        sb, bb = scale.bfloat16(), bias.bfloat16()
        res[f"1 rows={rows}"] = dict(
            ms=c.time_ms(functools.partial(layer_norm, x, scale, bias,
                                           eps=1e-5,
                                           out_dtype=torch.bfloat16)),
            library_ms=c.time_ms(lambda: F.layer_norm(x, (HIDDEN,), sb, bb,
                                                      1e-5)),
            bound_ms=c.bound(rows * HIDDEN * 2 * 2 + 2 * HIDDEN * 4,
                             8.0 * rows * HIDDEN)[0])
    for rows in BWD_ROWS:
        x, dy, scale, bias = c._ln_train_inputs(g, rows, HIDDEN, device)
        t = c.ln_bwd_times(x, dy, scale, bias, 1e-12)
        res[f"2 rows={rows}"] = {k: t[k] for k in ("ms", "library_ms",
                                                   "bound_ms")}
    bf16 = torch.bfloat16
    x, dy, scale, bias = c._ln_train_inputs(g, DAL_ROWS, HIDDEN, device)
    h = torch.randn(DAL_ROWS, HIDDEN, generator=g, device=device).to(bf16)
    kw = dict(rate=0.1, seed=77, site=0, eps=1e-12)
    _, s = _dal_fwd_cuda(h, x, scale, bias, out_dtype=bf16, save_s=True,
                         **kw)
    res[f"3 rows={DAL_ROWS}"] = dict(
        ms=c.time_ms(functools.partial(_dal_fwd_cuda, h, x, scale, bias,
                                       out_dtype=bf16, save_s=True, **kw)),
        bound_ms=c.dal_bound(DAL_ROWS, HIDDEN, n_rows_io=4, params=2,
                             rate=0.1)[0])
    res[f"4 rows={DAL_ROWS}"] = dict(
        ms=c.time_ms(lambda: _dal_bwd_cuda(s, dy, scale, **kw)),
        bound_ms=c.dal_bound(DAL_ROWS, HIDDEN, n_rows_io=4, params=3,
                             rate=0.1, kernel="dal_bwd_dx")[0])
    x, _, scale, bias = c._ln_train_inputs(g, DAL_EVAL_ROWS, HIDDEN, device)
    h = torch.randn(DAL_EVAL_ROWS, HIDDEN, generator=g,
                    device=device).to(bf16)
    res[f"3 rows={DAL_EVAL_ROWS} eval"] = dict(
        ms=c.time_ms(functools.partial(
            _dal_fwd_cuda, h, x, scale, bias, rate=0.0, seed=0, site=0,
            eps=1e-12, out_dtype=bf16, save_s=False)),
        bound_ms=c.dal_bound(DAL_EVAL_ROWS, HIDDEN, n_rows_io=3, params=2,
                             rate=0.0)[0])
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
    print(f"[ln-ab] {smi}", flush=True)
    runs = {t: [] for t in trees}
    for tree in trees + trees[::-1]:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", tree],
            capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            print(out.stdout[-4000:] + out.stderr[-8000:], file=sys.stderr)
            return 1
        res = json.loads(out.stdout.strip().splitlines()[-1])
        runs[tree].append(res)
        print(f"[ln-ab] {tree}: " + json.dumps(res), flush=True)
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
