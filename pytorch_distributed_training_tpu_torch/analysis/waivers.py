"""Waiver file: every lint finding is fixed or suppressed WITH A REASON
(counterpart: the JAX package's ``analysis/waivers.py``).

``analysis/waivers.toml`` holds an array of ``[[waiver]]`` tables:

    [[waiver]]
    rule = "host-sync-in-loop"
    file = "pytorch_distributed_training_tpu_torch/train/loop.py"
    symbol = "Trainer._run_epochs"       # optional: whole file if absent
    reason = "per-step loss fetch is the opt-in telemetry sync"

Matching: ``rule`` exact; ``file`` fnmatch against the repo-relative
path; ``symbol`` (when present) equals the finding's enclosing-function
qualname or a dotted prefix of it. ``reason`` is mandatory — a waiver
without one is a config error, not a suppression.

A minimal TOML-subset reader lives here, as in the JAX package (which
ran on Python 3.10, without the stdlib ``tomllib``): ``[[table]]``
headers, ``key = "string"`` pairs, comments and blank lines. That subset
IS the waiver format; using full TOML syntax beyond it is rejected
loudly.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import re

from pytorch_distributed_training_tpu_torch.analysis.rules.common import Finding


@dataclasses.dataclass(frozen=True)
class Waiver:
    rule: str
    file: str
    reason: str
    symbol: str | None = None

    def matches(self, finding: Finding) -> bool:
        if self.rule != finding.rule:
            return False
        path = finding.path.replace("\\", "/")
        if not fnmatch.fnmatch(path, self.file):
            return False
        if self.symbol is None:
            return True
        return finding.symbol == self.symbol or finding.symbol.startswith(
            self.symbol + "."
        )


_KV_RE = re.compile(r'^([A-Za-z_][A-Za-z0-9_-]*)\s*=\s*"((?:[^"\\]|\\.)*)"\s*$')


def parse_waivers_toml(text: str, *, source: str = "<waivers>") -> list[Waiver]:
    entries: list[dict] = []
    current: dict | None = None
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line == "[[waiver]]":
            current = {}
            entries.append(current)
            continue
        m = _KV_RE.match(line)
        if m is None:
            raise ValueError(
                f"{source}:{lineno}: unsupported waiver syntax {raw!r} "
                f"(expected [[waiver]] or key = \"value\")"
            )
        if current is None:
            raise ValueError(
                f"{source}:{lineno}: key outside a [[waiver]] table"
            )
        current[m.group(1)] = m.group(2).encode().decode("unicode_escape")

    waivers = []
    for i, e in enumerate(entries):
        missing = {"rule", "file", "reason"} - set(e)
        if missing:
            raise ValueError(
                f"{source}: waiver #{i + 1} missing {sorted(missing)} "
                f"(a waiver without a reason is not a waiver)"
            )
        unknown = set(e) - {"rule", "file", "symbol", "reason"}
        if unknown:
            raise ValueError(
                f"{source}: waiver #{i + 1} has unknown keys {sorted(unknown)}"
            )
        if not e["reason"].strip():
            raise ValueError(f"{source}: waiver #{i + 1} has an empty reason")
        waivers.append(Waiver(
            rule=e["rule"], file=e["file"], symbol=e.get("symbol"),
            reason=e["reason"],
        ))
    return waivers


def load_waivers(path: str) -> list[Waiver]:
    with open(path) as f:
        return parse_waivers_toml(f.read(), source=path)
