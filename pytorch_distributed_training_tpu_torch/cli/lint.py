"""Concurrency + host-sync linter CLI (analysis/lint.py driver; the port's
counterpart of the JAX package's ``scripts/lint.py``, with its flags).

    python -m pytorch_distributed_training_tpu_torch.cli.lint
    python -m pytorch_distributed_training_tpu_torch.cli.lint --check
    python -m pytorch_distributed_training_tpu_torch.cli.lint --json
    python -m pytorch_distributed_training_tpu_torch.cli.lint serve/
    python -m pytorch_distributed_training_tpu_torch.cli.lint --changed
    python -m pytorch_distributed_training_tpu_torch.cli.lint --changed REF

The default target is the port's package. Every finding must be fixed or
waived: ``analysis/waivers.toml`` holds ``[[waiver]]`` entries (rule +
file [+ symbol] + mandatory reason). With ``--metrics-dir`` the run
appends a ``lint_summary`` record to the same telemetry JSONL stream
training and serving write. ``--check`` exits 1 unless the tree lints
clean, modulo waivers; ``--changed`` lints only the files differing from
a git ref (and untracked ones), with unused-waiver warnings suppressed —
a subset run can't see every waiver's file.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from pytorch_distributed_training_tpu_torch.analysis.lint import (
    DEFAULT_WAIVERS,
    REPO_ROOT,
    lint_paths,
    summary_record,
)
from pytorch_distributed_training_tpu_torch.analysis.waivers import (
    load_waivers,
)

PACKAGE = "pytorch_distributed_training_tpu_torch"
DEFAULT_PATHS = [os.path.join(REPO_ROOT, PACKAGE)]


def changed_files(ref: str = "HEAD", repo_root: str = REPO_ROOT) -> list:
    """The port package's .py files differing from ``ref`` (tracked diffs
    + untracked new files), absolute paths. Raises on a git failure —
    --changed in a non-repo is an input error, not an empty success."""
    diff = subprocess.run(
        ["git", "diff", "--name-only", ref, "--"],
        cwd=repo_root, capture_output=True, text=True, check=True,
    ).stdout.splitlines()
    untracked = subprocess.run(
        ["git", "ls-files", "--others", "--exclude-standard"],
        cwd=repo_root, capture_output=True, text=True, check=True,
    ).stdout.splitlines()
    out = []
    for rel in sorted(set(diff) | set(untracked)):
        if not (rel.endswith(".py") and rel.startswith(PACKAGE + "/")):
            continue
        path = os.path.join(repo_root, rel)
        if os.path.exists(path):    # deleted files have nothing to lint
            out.append(path)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("paths", nargs="*", default=None,
                   help="files/dirs to lint (default: the package)")
    p.add_argument("--changed", nargs="?", const="HEAD", default=None,
                   metavar="REF",
                   help="lint only files differing from REF (default HEAD) "
                        "plus untracked .py files — fast iteration; the "
                        "full-repo gate stays in tier-1")
    p.add_argument("--check", action="store_true",
                   help="exit 1 when any unwaived finding (or parse error) "
                        "remains")
    p.add_argument("--rules", default=None, metavar="ID,ID,...",
                   help="comma-separated rule ids to run (e.g. "
                        "host-sync-in-loop,unbounded-wait); other rules' "
                        "waivers are never reported unused")
    p.add_argument("--json", action="store_true",
                   help="print the full report as JSON")
    p.add_argument("--waivers", default=DEFAULT_WAIVERS,
                   help="waiver file (TOML subset; see analysis/waivers.py)")
    p.add_argument("--no-waivers", action="store_true",
                   help="ignore the waiver file (show every raw finding)")
    p.add_argument("--metrics-dir", default=None,
                   help="append a lint_summary record to this telemetry dir")
    args = p.parse_args(argv)

    waivers = []
    if not args.no_waivers and os.path.exists(args.waivers):
        waivers = load_waivers(args.waivers)
    if args.changed is not None:
        if args.paths:
            p.error("--changed and explicit paths are mutually exclusive")
        paths = changed_files(args.changed)
        if not paths:
            print(f"0 files changed vs {args.changed}: nothing to lint")
            return 0
    else:
        paths = args.paths or DEFAULT_PATHS
    rule_ids = None
    if args.rules is not None:
        rule_ids = tuple(r for r in args.rules.split(",") if r)
        if not rule_ids:
            p.error("--rules needs at least one rule id")
    try:
        report = lint_paths(paths, waivers, rule_ids=rule_ids)
    except ValueError as e:    # unknown rule id
        p.error(str(e))
    if args.changed is not None:
        # a subset run can't see every waiver's file — unused here != dead
        report.unused_waivers = []
    summary = summary_record(report)

    if args.metrics_dir:
        from pytorch_distributed_training_tpu_torch.telemetry.sink import (
            JsonlSink,
        )

        sink = JsonlSink(args.metrics_dir)
        sink.emit(summary)
        sink.close()

    if args.json:
        print(json.dumps({
            **summary,
            "findings_detail": [vars(f) for f in report.findings],
            "waived_detail": [
                {**vars(f), "reason": w.reason} for f, w in report.waived
            ],
            "unused_waivers": [vars(w) for w in report.unused_waivers],
            "errors": report.errors,
        }, indent=1))
    else:
        for f in report.findings:
            print(f.format())
        for e in report.errors:
            print(f"ERROR {e}")
        for w in report.unused_waivers:
            print(
                f"warning: unused waiver rule={w.rule} file={w.file} "
                f"symbol={w.symbol}", file=sys.stderr,
            )
        print(
            f"{report.files} files: {len(report.findings)} finding(s), "
            f"{len(report.waived)} waived, "
            f"{len(report.unused_waivers)} unused waiver(s)"
        )

    if args.check and not report.clean:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
