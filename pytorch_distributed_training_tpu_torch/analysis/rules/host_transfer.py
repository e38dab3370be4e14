"""Rule ``host-sync-in-loop`` (counterpart: the JAX package's
``analysis/rules/host_transfer.py``, its host half; the traced half,
``host-transfer-traced``, reads JAX's traced scopes, which the eager port
does not have).

A device value crossing to the host inside a ``for``/``while`` body of
host code in the hot subsystems (``train/``, ``serve/``): ``.item()``,
``.tolist()``, ``.cpu()``, ``.numpy()`` and ``torch.cuda.synchronize``.
Each one is a device sync serializing the launch stream — the
regressions that erase prefetch and asynchronous-dispatch wins. The
receiver's device is not visible in source, so a call on a host tensor
counts too; intentional syncs (per-step telemetry, one readback a tick)
and host-only ones get waivers with the reason, so a new one showing up
fails ``cli/lint.py --check``.
"""

from __future__ import annotations

import ast

from pytorch_distributed_training_tpu_torch.analysis.rules.common import (
    Finding,
    ModuleContext,
)

LOOP_RULE_ID = "host-sync-in-loop"
RULE_IDS = (LOOP_RULE_ID,)

_SYNC_CALLS = ("torch.cuda.synchronize",)
_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")

# module-path fragments whose host loops are hot (launch-stream) code
_HOT_SUBSYSTEMS = ("train/", "serve/")


def _sync_call(ctx: ModuleContext, node: ast.Call) -> str | None:
    """Describe ``node`` if it is a host sync, else None."""
    if ctx.resolve(node.func) in _SYNC_CALLS:
        return ctx.resolve(node.func)
    if (
        isinstance(node.func, ast.Attribute)
        and node.func.attr in _SYNC_METHODS
    ):
        return f".{node.func.attr}()"
    return None


def check(ctx: ModuleContext) -> list[Finding]:
    findings: list[Finding] = []
    path = ctx.path.replace("\\", "/")
    if not any(s in path for s in _HOT_SUBSYSTEMS):
        return findings
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        func = ctx.enclosing_function(node)
        # in a loop body of the SAME function?
        in_loop = False
        cur = ctx.parents.get(node)
        while cur is not None and cur is not func:
            if isinstance(cur, (ast.For, ast.While)):
                in_loop = True
                break
            cur = ctx.parents.get(cur)
        if not in_loop:
            continue
        what = _sync_call(ctx, node)
        if what is not None:
            findings.append(Finding(
                LOOP_RULE_ID, ctx.path, node.lineno, node.col_offset,
                ctx.qualname_of(node),
                f"host sync `{what}` inside a hot-path loop — one device "
                f"round-trip per iteration serializes the launch stream",
            ))
    return findings
