"""Rules ``lock-order-cycle`` and ``blocking-call-in-lock``.

(Counterpart: the JAX package's ``analysis/rules/lock_discipline.py``,
a copy.)

- **lock-order-cycle**: a statically derived lock-acquisition-order graph
  per module. Every ``with self.A:`` containing (lexically, or through
  the intra-class call graph) a ``with self.B:`` adds the edge
  ``Class.A -> Class.B``; a cycle in the resulting graph is a potential
  deadlock — two threads taking the same pair of locks in opposite
  orders need only unlucky timing. The report names one edge of the
  cycle; the fix is a single global order (or collapsing to one lock).
- **blocking-call-in-lock**: a call that can block indefinitely made
  while a lock is held — ``t.join()``, ``e.wait()`` / ``q.get()``
  WITHOUT a timeout, HTTP requests (``conn.request``/``getresponse``,
  ``urlopen``), ``subprocess`` waits and ``time.sleep``. Every other
  thread needing that lock now waits on the slow thing too; if the slow
  thing needs one of those threads, that's a deadlock. ``Condition``
  waits are exempt — ``cond.wait()`` RELEASES the lock by contract.

Both rules see through the one-hop private-call pattern (``swap_to``
holds the lock, ``_swap_to_locked`` does the work) via the threadmodel
lock-propagation fixpoint.
"""

from __future__ import annotations

import ast

from pytorch_distributed_training_tpu_torch.analysis.rules.common import (
    Finding,
    ModuleContext,
)
from pytorch_distributed_training_tpu_torch.analysis.rules.threadmodel import (
    class_models,
)

RULE_ID = "lock-order-cycle"
BLOCKING_RULE_ID = "blocking-call-in-lock"
RULE_IDS = (RULE_ID, BLOCKING_RULE_ID)

#: method names that block until an external event with no bound unless a
#: timeout argument is passed
_TIMEOUT_BLOCKERS = {"wait", "join", "get", "acquire"}
#: method names that block on I/O / other processes regardless of
#: arguments (matched on any receiver — ``conn.request`` style)
_ALWAYS_BLOCKER_METHODS = {
    "request", "getresponse", "urlopen", "communicate",
}
#: fully-resolved callables that always block
_ALWAYS_BLOCKER_CALLS = {
    "time.sleep", "subprocess.run", "subprocess.check_call",
    "subprocess.check_output", "urllib.request.urlopen",
}


def _has_timeout(call: ast.Call) -> bool:
    if call.args:
        return True     # positional timeout (wait(5), get(0.1))
    return any(kw.arg == "timeout" for kw in call.keywords)


def _cond_attrs(ctx: ModuleContext) -> set[str]:
    """Attribute names assigned a ``threading.Condition`` anywhere in the
    module — their ``.wait()`` releases the associated lock by contract."""
    out: set[str] = set()
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Assign) and isinstance(
            node.value, ast.Call
        )):
            continue
        resolved = ctx.resolve(node.value.func) or ""
        if resolved.rsplit(".", 1)[-1] == "Condition":
            for tgt in node.targets:
                if isinstance(tgt, ast.Attribute):
                    out.add(tgt.attr)
                elif isinstance(tgt, ast.Name):
                    out.add(tgt.id)
    return out


def _blocking_call(ctx: ModuleContext, node: ast.Call,
                   cond_attrs: set[str]) -> str | None:
    """Describe ``node`` if it can block unboundedly, else None."""
    resolved = ctx.resolve(node.func)
    if resolved in _ALWAYS_BLOCKER_CALLS:
        return resolved
    if not isinstance(node.func, ast.Attribute):
        return None
    name = node.func.attr
    if name in _ALWAYS_BLOCKER_METHODS:
        return f".{name}()"
    if name in _TIMEOUT_BLOCKERS and not _has_timeout(node):
        recv = node.func.value
        tail = recv.attr if isinstance(recv, ast.Attribute) else (
            recv.id if isinstance(recv, ast.Name) else ""
        )
        if tail in cond_attrs or "cond" in tail:
            return None     # Condition.wait releases the lock
        return f".{name}()"
    return None


def check(ctx: ModuleContext) -> list[Finding]:
    findings: list[Finding] = []
    cond_attrs = _cond_attrs(ctx)

    # ---------------- lock-order graph + blocking calls, per class -------
    edges: dict[str, set[str]] = {}
    edge_sites: dict[tuple, ast.AST] = {}

    for model in class_models(ctx):
        if not model.lock_attrs:
            continue
        cls_name = ctx.qualnames.get(model.cls, model.cls.name)

        for mname, method in model.methods.items():
            held_map = model._held_map(mname)
            base = model.locks_at(mname, method)    # propagated entry locks

            for node in ast.walk(method):
                held = held_map.get(id(node))
                if held is None:
                    continue
                held = held | base
                # order edges: every held lock -> a newly acquired one
                if isinstance(node, ast.With):
                    for item in node.items:
                        attr = None
                        expr = item.context_expr
                        if (
                            isinstance(expr, ast.Attribute)
                            and isinstance(expr.value, ast.Name)
                            and expr.value.id == "self"
                            and expr.attr in model.lock_attrs
                        ):
                            attr = expr.attr
                        if attr is None:
                            continue
                        for h in held:
                            if h == attr:
                                continue
                            a, b = f"{cls_name}.{h}", f"{cls_name}.{attr}"
                            edges.setdefault(a, set()).add(b)
                            edge_sites.setdefault((a, b), node)
                if not held:
                    continue
                if isinstance(node, ast.Call):
                    what = _blocking_call(ctx, node, cond_attrs)
                    if what is not None:
                        findings.append(Finding(
                            BLOCKING_RULE_ID, ctx.path, node.lineno,
                            node.col_offset, f"{cls_name}.{mname}",
                            f"blocking call `{what}` while holding lock(s) "
                            f"{sorted(held)} — every thread needing the "
                            f"lock now waits on it too; release first or "
                            f"bound it with a timeout",
                        ))

    # ---------------- cycle detection over the module's order graph ------
    def reaches(src: str, dst: str, seen: set) -> bool:
        if src == dst:
            return True
        seen.add(src)
        return any(
            n not in seen and reaches(n, dst, seen)
            for n in edges.get(src, ())
        )

    reported: set = set()
    for a, succs in sorted(edges.items()):
        for b in sorted(succs):
            if frozenset((a, b)) in reported:
                continue
            if reaches(b, a, set()):
                reported.add(frozenset((a, b)))
                site = edge_sites[(a, b)]
                findings.append(Finding(
                    RULE_ID, ctx.path, site.lineno, site.col_offset,
                    ctx.qualname_of(site),
                    f"lock-order cycle: `{a}` is taken before `{b}` here, "
                    f"but `{b}` is (transitively) taken before `{a}` "
                    f"elsewhere — two threads interleaving these orders "
                    f"deadlock; pick one global order",
                ))
    return findings
