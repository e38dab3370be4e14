"""Lint driver: parse -> per-rule checks -> waiver fold -> report
(counterpart: the JAX package's ``analysis/lint.py``).

``lint_paths`` walks files/directories, builds one ``ModuleContext`` per
parseable Python file and runs every registered rule (``rules/``) over
it. Waivers (``waivers.py``) split raw findings into *active* (must be
fixed) and *waived* (documented-intentional); unused waivers are
reported so dead suppressions rot out of the file.

``cli/lint.py`` is the CLI; ``summary_record`` shapes the result as
a ``lint_summary`` telemetry record so lint health rides the same JSONL
stream as runtime metrics (``scripts/summarize_metrics.py`` folds it).
"""

from __future__ import annotations

import ast
import dataclasses
import os

from pytorch_distributed_training_tpu_torch.analysis.rules import ALL_RULES, _ids
from pytorch_distributed_training_tpu_torch.analysis.rules.common import (
    Finding,
    ModuleContext,
)
from pytorch_distributed_training_tpu_torch.analysis.waivers import Waiver

# repo root = parent of the package dir (analysis/ is one level in)
REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_WAIVERS = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "waivers.toml"
)

_SKIP_DIRS = {"__pycache__", ".git", ".pytest_cache", "build", "_build"}


@dataclasses.dataclass
class LintReport:
    findings: list[Finding]            # active (unwaived)
    waived: list[tuple[Finding, Waiver]]
    unused_waivers: list[Waiver]
    files: int
    errors: list[str]                  # unparseable files

    @property
    def clean(self) -> bool:
        return not self.findings and not self.errors

    def by_rule(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out


def select_rules(rule_ids) -> tuple:
    """Rule modules reporting any of ``rule_ids`` (``--rules`` filter).
    Raises ``ValueError`` on an id no registered rule reports."""
    wanted = set(rule_ids)
    known = {rid for mod in ALL_RULES for rid in _ids(mod)}
    unknown = sorted(wanted - known)
    if unknown:
        raise ValueError(
            f"unknown rule id(s) {unknown}; known: {sorted(known)}"
        )
    return tuple(m for m in ALL_RULES if wanted & set(_ids(m)))


def _rel(path: str) -> str:
    path = os.path.abspath(path)
    try:
        rel = os.path.relpath(path, REPO_ROOT)
    except ValueError:  # different drive (windows)
        return path
    return path if rel.startswith("..") else rel.replace(os.sep, "/")


def lint_source(
    source: str, path: str = "<string>", rules=ALL_RULES
) -> list[Finding]:
    """Lint one source string (rule unit tests drive this directly)."""
    tree = ast.parse(source, filename=path)
    ctx = ModuleContext(path, source, tree)
    findings: list[Finding] = []
    for rule in rules:
        findings.extend(rule.check(ctx))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def iter_python_files(paths: list[str]) -> list[str]:
    out: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs if d not in _SKIP_DIRS)
                out.extend(
                    os.path.join(root, f)
                    for f in sorted(files)
                    if f.endswith(".py")
                )
        elif p.endswith(".py"):
            out.append(p)
    return out


def lint_paths(
    paths: list[str],
    waivers: list[Waiver] | None = None,
    rules=ALL_RULES,
    rule_ids=None,
) -> LintReport:
    """With ``rule_ids`` (the ``--rules`` filter) only those finding ids
    are reported, and only waivers owned by them can count as unused — a
    subset run must not flag other rules' waivers as dead."""
    if rule_ids is not None:
        rules = select_rules(rule_ids)
        waivers = [w for w in (waivers or []) if w.rule in set(rule_ids)]
    waivers = list(waivers or [])
    all_findings: list[Finding] = []
    errors: list[str] = []
    files = iter_python_files(paths)
    for fpath in files:
        try:
            with open(fpath, encoding="utf-8") as f:
                source = f.read()
            all_findings.extend(lint_source(source, _rel(fpath), rules))
        except (SyntaxError, UnicodeDecodeError) as e:
            errors.append(f"{_rel(fpath)}: unparseable: {e}")
    if rule_ids is not None:
        # a module selected for one of its ids reports ALL its ids —
        # narrow to exactly what was asked for
        all_findings = [f for f in all_findings if f.rule in set(rule_ids)]

    active: list[Finding] = []
    waived: list[tuple[Finding, Waiver]] = []
    used: set[int] = set()
    for finding in all_findings:
        for i, w in enumerate(waivers):
            if w.matches(finding):
                waived.append((finding, w))
                used.add(i)
                break
        else:
            active.append(finding)
    unused = [w for i, w in enumerate(waivers) if i not in used]
    active.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return LintReport(
        findings=active, waived=waived, unused_waivers=unused,
        files=len(files), errors=errors,
    )


def summary_record(report: LintReport) -> dict:
    """Shape a report as the ``lint_summary`` telemetry record."""
    return {
        "record": "lint_summary",
        "files": report.files,
        "findings": len(report.findings),
        "waived": len(report.waived),
        "unused_waivers": len(report.unused_waivers),
        # the owning rule ids, so a dead suppression is findable from the
        # telemetry stream alone
        "unused_waiver_rules": sorted(
            {w.rule for w in report.unused_waivers}
        ),
        "parse_errors": len(report.errors),
        "by_rule": report.by_rule(),
        "clean": report.clean,
    }
