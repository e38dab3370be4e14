#!/usr/bin/env python3
"""Where ``chip_smoke.py``'s wall time goes: run its ``main`` while a
thread samples the main thread's stack every ``--interval`` seconds, then
write the seconds by call chain of ``chip_smoke`` functions (and by chain
and innermost frame) as JSON and print the largest.

    python3 scripts/smoke_sample.py [--out smoke_samples.json]

Run from a checkout on a machine with one H100, as ``chip_smoke.py`` is,
and allow it about 1300 s. Its exit code is ``chip_smoke.py``'s. The
processes ``chip_smoke.py`` starts are not sampled: their time shows as
the main thread's wait on them.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import runpy
import sys
import threading

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="smoke_samples.json")
    p.add_argument("--interval", type=float, default=0.2)
    p.add_argument("--top", type=int, default=40)
    args = p.parse_args()
    os.chdir(ROOT)
    sys.path.insert(0, ROOT)
    chains, leaves = collections.Counter(), collections.Counter()
    main_id = threading.main_thread().ident
    done = threading.Event()

    def sample():
        while not done.wait(args.interval):
            frame = sys._current_frames().get(main_id)
            chain, leaf = [], None
            while frame is not None:
                code = frame.f_code
                if leaf is None:
                    leaf = (f"{os.path.basename(code.co_filename)}:"
                            f"{code.co_name}")
                if code.co_filename.endswith("chip_smoke.py"):
                    chain.append(code.co_name)
                frame = frame.f_back
            key = " > ".join(reversed(chain))
            chains[key] += args.interval
            leaves[f"{key} || {leaf}"] += args.interval

    threading.Thread(target=sample, daemon=True).start()
    rc = 0
    try:
        sys.argv = ["chip_smoke.py"]
        runpy.run_path(os.path.join(ROOT, "chip_smoke.py"),
                       run_name="__main__")
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else (0 if e.code is None
                                                      else 1)
    finally:
        done.set()
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"interval_s": args.interval,
                       "chains": chains.most_common(),
                       "leaves": leaves.most_common()}, f, indent=0)
        for key, s in chains.most_common(args.top):
            print(f"[sample] {s:8.1f} s {key}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
