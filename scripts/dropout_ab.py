#!/usr/bin/env python3
"""Time the port's dropout (kernel 5, ``csrc/dropout.cu``) from several
source trees in turns, on one CUDA card.

    python3 scripts/dropout_ab.py OLD_TREE NEW_TREE [MORE_TREES ...]

Each TREE is the root of a checkout of this repository (for the parent
commit: ``git archive <commit> | tar -x -C _archive/parent``). The trees
run forward and then backward (old, new, new, old), each in a process of
its own that builds that tree's ``csrc/dropout.cu``, counts the integer
instructions an element of its Philox loop in the library's SASS
(``chip_smoke.sass_per_element``), and times with ``chip_smoke.py``'s
CUDA-graph timer (``time_ms``), bf16, rate 0.1, at ``SHAPES``, through the
tree's public entry points:

- ``mask``: ``mask_scale``, the mask-scale tensor alone;
- ``dropout``: ``raw_dropout``'s forward (a tree that multiplies by the
  mask-scale launches kernel 5 and an aten mul; one that applies the mask
  in the kernel, one launch);
- ``dropout_train``: its forward and backward (``torch.autograd.grad``);

beside ``F.dropout`` (``library``) and the byte bound of the forward (x
read, y written). The timing code and inputs are this script's and this
repository's ``chip_smoke.py``; only the kernels come from the tree.
Prints the card's name and power limit, one JSON line a run, and last a
JSON summary: each tree's numbers, min..max over its runs.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# BERT's probs (micro 8, 16 heads, seq 128), lm-1024's residual sites,
# BERT's embeddings, its classifier
SHAPES = ((8, 16, 128, 128), (4, 1024, 1024), (8, 128, 1024), (8, 1024))
RATE = 0.1
SEED, SITE = 9, 2
# the Philox loop of each tree's bf16 kernel: (symbol pattern, elements an
# iteration); the first that matches
SASS_KERNELS = ((r"mask_scale_kernelI13__nv_bfloat16E", 4),
                (r"dropout_kernelI13__nv_bfloat16jLb1E", 8))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_one(tree: str) -> dict:
    """Build ``tree``'s dropout kernel, count and time it (this process
    only)."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    import torch.nn.functional as F

    from pytorch_distributed_training_tpu_torch.ops import _build
    from pytorch_distributed_training_tpu_torch.ops import dropout as d

    c = _chip_smoke()
    if not torch.cuda.is_available():
        raise SystemExit("dropout_ab: no CUDA GPU visible")
    _build.build(["dropout"])
    funcs = c.sass_functions(str(_build._lib_path("dropout")))
    res = {}
    for pattern, elements in SASS_KERNELS:
        hits = [n for n in funcs if re.search(pattern, n)]
        if hits:
            sass = c.sass_per_element(funcs[hits[0]], elements)
            res["sass"] = {k: sass[k] for k in ("fma_heavy", "alu",
                                                "loop_instructions",
                                                "elements")}
            break
    device = torch.device("cuda")
    g = torch.Generator(device=device).manual_seed(0)
    bf16 = torch.bfloat16
    for shape in SHAPES:
        x = torch.randn(shape, generator=g, device=device).to(bf16)
        dy = torch.randn(shape, generator=g, device=device).to(bf16)
        xg = x.clone().requires_grad_()

        def train():
            return torch.autograd.grad(d.raw_dropout(xg, RATE, SEED, SITE),
                                       xg, dy)

        t = dict(
            mask=c.time_ms(lambda: d.mask_scale(shape, RATE, bf16, seed=SEED,
                                                site=SITE, device=device)),
            dropout=c.time_ms(lambda: d.raw_dropout(x, RATE, SEED, SITE)),
            dropout_train=c.time_ms(train),
            library=c.time_ms(lambda: F.dropout(x, RATE, training=True)),
            bound=c.bound(4 * math.prod(shape), 0.0)[0],
        )
        res[str(list(shape))] = t
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
    print(f"[dropout-ab] {smi}", flush=True)
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
        print(f"[dropout-ab] {tree}: " + json.dumps(res), flush=True)
    summary = {
        tree: {key: {m: [min(r[key][m] for r in rs),
                         max(r[key][m] for r in rs)]
                     for m in rs[0][key]}
               for key in rs[0]}
        for tree, rs in runs.items()}
    print(json.dumps({"device": smi, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
