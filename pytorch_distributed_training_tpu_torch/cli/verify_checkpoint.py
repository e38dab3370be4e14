"""Offline checkpoint validator, the gate before a resume or a publish
(counterpart: the JAX package's ``scripts/verify_checkpoint.py``).

Walks every step under a checkpoint directory (a run's
``--checkpoint-dir``) and verifies each against its integrity manifest
(``train/manifest.py``): the file inventory by byte size, and with
``--strict`` a full sha256 re-hash that catches same-size corruption::

    python -m pytorch_distributed_training_tpu_torch.cli.verify_checkpoint \\
        /ckpts/run17 --strict [--json] [--step N]

``--json`` prints one report (each step's verdict and reason, the sha256
digests each manifest records, and the step a restore would use) instead
of the table.

Exit codes:
  0 — every step verified;
  2 — some steps failed but a verified step exists (a resume falls back
      to the newest verified step);
  3 — corrupt: steps exist but none verifies (a resume would need
      ``--checkpoint-verify off``, at your own risk);
  4 — missing: the directory does not exist, holds no checkpoint, or the
      requested ``--step`` is absent.

Touches no device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

EXIT_VERIFIED = 0
EXIT_PARTIAL = 2
EXIT_CORRUPT = 3
EXIT_MISSING = 4


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("directory",
                   help="checkpoint directory (a run's --checkpoint-dir)")
    p.add_argument("--step", type=int, default=None,
                   help="verify only this step (default: every step)")
    p.add_argument("--strict", action="store_true",
                   help="re-hash every file (sha256) instead of size-only: "
                        "catches same-size corruption; costs a full read")
    p.add_argument("--quiet", action="store_true",
                   help="exit code only, no per-step report")
    p.add_argument("--json", action="store_true",
                   help="print one JSON report (per-step verdict and "
                        "manifest digests) instead of the table")
    return p


def main(argv=None) -> int:
    from pytorch_distributed_training_tpu_torch.train import manifest
    from pytorch_distributed_training_tpu_torch.train.checkpoint import (
        all_steps,
        step_path,
    )

    args = build_parser().parse_args(argv)
    directory = os.path.abspath(args.directory)
    level = "digest" if args.strict else "size"

    def report_missing(message: str) -> int:
        if args.json:
            print(json.dumps({
                "directory": directory,
                "level": level,
                "verdict": "missing",
                "error": message,
                "steps": [],
            }))
        else:
            print(message, file=sys.stderr)
        return EXIT_MISSING

    if not os.path.isdir(directory):
        return report_missing(f"{directory}: not a directory")
    steps = all_steps(directory)
    if args.step is not None:
        if args.step not in steps:
            return report_missing(f"step {args.step} not found (have {steps})")
        steps = [args.step]
    results = {}
    for step in steps:
        path = step_path(directory, step)
        ok, reason = manifest.verify_step(path, level=level)
        m = manifest.read_manifest(path) or {}
        results[step] = {
            "step": step,
            "ok": ok,
            "reason": reason,
            # the digests the manifest claims; verify_step recomputed them
            "digests": {rel: info.get("sha256")
                        for rel, info in (m.get("files") or {}).items()},
        }
    if not results:
        return report_missing(f"no checkpoint under {directory}")
    verified = [s for s, r in results.items() if r["ok"]]
    newest = max(verified) if verified else None
    if len(verified) == len(results):
        verdict, code = "verified", EXIT_VERIFIED
    elif verified:
        verdict, code = "partial", EXIT_PARTIAL
    else:
        verdict, code = "corrupt", EXIT_CORRUPT
    if args.json:
        print(json.dumps({
            "directory": directory,
            "level": level,
            "verdict": verdict,
            "verified": len(verified),
            "total": len(results),
            "verified_latest": newest,
            "steps": [results[s] for s in sorted(results)],
        }, indent=1))
    elif not args.quiet:
        for step, r in sorted(results.items()):
            print(f"step {step:>8}: {'OK' if r['ok'] else 'FAIL'} "
                  f"({r['reason']})")
        print(f"{len(verified)}/{len(results)} step(s) verified at level "
              f"{level!r}; restore would use: "
              f"{newest if newest is not None else 'NOTHING — no verified step'}")
    return code


if __name__ == "__main__":
    sys.exit(main())
