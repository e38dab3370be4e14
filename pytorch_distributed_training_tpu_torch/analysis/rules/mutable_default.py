"""Rule ``mutable-default``: mutable default argument values.

(Counterpart: the JAX package's ``analysis/rules/mutable_default.py``,
a copy.)

The classic shared-state footgun: ``def f(x, acc=[])`` builds ONE list at
definition time, shared across every call. In a library that ships
long-lived Trainer/engine objects this shows up as state bleeding across
runs. Flags list/dict/set literals and ``list()``/``dict()``/``set()``
calls used as parameter defaults.
"""

from __future__ import annotations

import ast

from pytorch_distributed_training_tpu_torch.analysis.rules.common import (
    Finding,
    ModuleContext,
)

RULE_ID = "mutable-default"


def _is_mutable(node: ast.AST) -> bool:
    if isinstance(node, (ast.List, ast.Dict, ast.Set)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
        return node.func.id in ("list", "dict", "set", "bytearray")
    return False


def check(ctx: ModuleContext) -> list[Finding]:
    findings: list[Finding] = []
    for func in ctx.functions():
        qual = ctx.qualnames.get(func, func.name)
        defaults = [
            *func.args.defaults,
            *[d for d in func.args.kw_defaults if d is not None],
        ]
        for d in defaults:
            if _is_mutable(d):
                findings.append(Finding(
                    RULE_ID, ctx.path, d.lineno, d.col_offset, qual,
                    "mutable default argument — shared across calls; "
                    "default to None and build inside",
                ))
    return findings
