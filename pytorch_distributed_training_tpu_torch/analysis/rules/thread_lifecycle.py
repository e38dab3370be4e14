"""Rules ``non-daemon-thread`` and ``unbounded-wait``.

(Counterpart: the JAX package's ``analysis/rules/thread_lifecycle.py``,
a copy.)

Thread lifecycle hygiene — the two shutdown hangs:

- **non-daemon-thread**: a ``threading.Thread(...)`` started without
  ``daemon=True`` and never ``join``ed anywhere in the module keeps the
  interpreter alive after main exits — the process "finishes" and then
  sits there. Either daemonize (and own a close path) or join it.
- **unbounded-wait**: ``event.wait()`` / ``thread.join()`` /
  ``queue.get()`` with no timeout, in a module that uses threading. The
  waiter hangs forever if the thread that would have signaled it died —
  a serve loop once hung exactly so. Bound the
  wait and re-check liveness, or waive with the reason the owner cannot
  die first. ``Condition`` waits are exempt (woken under the same lock's
  protocol; the monitor pattern is the legitimate unbounded wait).
"""

from __future__ import annotations

import ast

from pytorch_distributed_training_tpu_torch.analysis.rules.common import (
    Finding,
    ModuleContext,
)

RULE_ID = "non-daemon-thread"
WAIT_RULE_ID = "unbounded-wait"
RULE_IDS = (RULE_ID, WAIT_RULE_ID)

_WAITERS = ("wait", "join", "get")


def _uses_threading(ctx: ModuleContext) -> bool:
    return any(
        v == "threading" or v.startswith("threading.")
        for v in ctx.aliases.values()
    )


def _cond_like(recv: ast.AST) -> bool:
    tail = ""
    if isinstance(recv, ast.Attribute):
        tail = recv.attr
    elif isinstance(recv, ast.Name):
        tail = recv.id
    return "cond" in tail.lower()


def _cond_attr_names(ctx: ModuleContext) -> set[str]:
    out: set[str] = set()
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            resolved = ctx.resolve(node.value.func) or ""
            if resolved.rsplit(".", 1)[-1] == "Condition":
                for tgt in node.targets:
                    if isinstance(tgt, ast.Attribute):
                        out.add(tgt.attr)
                    elif isinstance(tgt, ast.Name):
                        out.add(tgt.id)
    return out


def check(ctx: ModuleContext) -> list[Finding]:
    findings: list[Finding] = []
    if not _uses_threading(ctx):
        return findings
    cond_names = _cond_attr_names(ctx)

    # collect every name/attr a .join( is called on, for the daemon rule
    joined: set[str] = set()
    for node in ast.walk(ctx.tree):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "join"
        ):
            recv = node.func.value
            if isinstance(recv, ast.Attribute):
                joined.add(recv.attr)
            elif isinstance(recv, ast.Name):
                joined.add(recv.id)

    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue

        # ------------------------------------------------ non-daemon-thread
        resolved = ctx.resolve(node.func) or ""
        if resolved.rsplit(".", 1)[-1] == "Thread":
            daemon = next(
                (kw.value for kw in node.keywords if kw.arg == "daemon"),
                None,
            )
            daemonized = (
                isinstance(daemon, ast.Constant) and bool(daemon.value)
            )
            if not daemonized:
                # joined anywhere? resolve the assignment target's name
                parent = ctx.parents.get(node)
                target_names: set[str] = set()
                if isinstance(parent, ast.Assign):
                    for tgt in parent.targets:
                        if isinstance(tgt, ast.Attribute):
                            target_names.add(tgt.attr)
                        elif isinstance(tgt, ast.Name):
                            target_names.add(tgt.id)
                if not (target_names & joined):
                    findings.append(Finding(
                        RULE_ID, ctx.path, node.lineno, node.col_offset,
                        ctx.qualname_of(node),
                        "thread started non-daemon and never joined in "
                        "this module — it outlives main and blocks "
                        "interpreter exit; pass daemon=True (with a close "
                        "path) or join it",
                    ))

        # --------------------------------------------------- unbounded-wait
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in _WAITERS
            and not node.args
            and not any(kw.arg == "timeout" for kw in node.keywords)
        ):
            recv = node.func.value
            if _cond_like(recv):
                continue
            tail = (
                recv.attr if isinstance(recv, ast.Attribute)
                else recv.id if isinstance(recv, ast.Name) else ""
            )
            if tail in cond_names:
                continue
            findings.append(Finding(
                WAIT_RULE_ID, ctx.path, node.lineno, node.col_offset,
                ctx.qualname_of(node),
                f"`.{node.func.attr}()` with no timeout in a threaded "
                f"module — hangs forever if the signaling thread died; "
                f"bound it and re-check liveness (or waive with the "
                f"reason the owner cannot die first)",
            ))
    return findings
