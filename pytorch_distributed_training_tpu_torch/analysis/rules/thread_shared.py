"""Rules ``thread-shared-mutable`` and ``unlocked-rmw``.

(Counterpart: the JAX package's ``analysis/rules/thread_shared.py``,
a copy.)

The two statically-visible shapes of a data race on ``self`` state:

- **thread-shared-mutable**: an attribute written from one thread root
  (a ``Thread(target=self._x)`` body and everything it calls) and
  read/written from a different root (another thread entry, or the
  "external" root — any method other threads may call) with no common
  lock across the conflicting accesses. Torn ``JsonlSink`` lines were
  once exactly this shape.
- **unlocked-rmw**: a read-modify-write (``self.n += 1``,
  ``self.xs.append(...)``, ``self.d[k] = ...``) with no lock held, in an
  externally-callable method of a class that is visibly concurrent
  (starts threads or owns locks). Two HTTP handler threads running the
  same method race each other — the GIL makes each bytecode atomic, not
  the read-increment-store sequence.

``thread-shared-mutable`` also reasons CROSS-class: an attribute handed
to another class's thread root — ``Worker(self.buf)`` where ``Worker``
starts threads, or ``Thread(target=f, args=(self.buf,))`` — is shared
with that thread from the moment it starts, so an unlocked write to it
from the handing class races the receiver's thread even though the
handing class starts no thread of its own.

Exemptions (see ``threadmodel``): lock attrs and thread-safe-by-
construction attrs (Events, Queues, semaphores, deques — handing a
Queue to a worker is the sanctioned pattern), accesses in ``__init__``
(construction happens-before thread start), and methods whose every
call site provably holds a lock. Single-writer flags a class publishes
deliberately (``_loop_failed``-style booleans) are the waiver file's
job — with the reason the pattern is safe.
"""

from __future__ import annotations

import ast

from pytorch_distributed_training_tpu_torch.analysis.rules.common import (
    Finding,
    ModuleContext,
)
from pytorch_distributed_training_tpu_torch.analysis.rules.threadmodel import (
    EXTERNAL,
    class_models,
)

RULE_ID = "thread-shared-mutable"
RMW_RULE_ID = "unlocked-rmw"
RULE_IDS = (RULE_ID, RMW_RULE_ID)


def _self_attr_loads(expr: ast.AST):
    """``self.X`` attributes loaded anywhere inside ``expr``."""
    for sub in ast.walk(expr):
        if (
            isinstance(sub, ast.Attribute)
            and isinstance(sub.value, ast.Name)
            and sub.value.id == "self"
            and isinstance(sub.ctx, ast.Load)
        ):
            yield sub.attr


def _handed_to_thread_roots(ctx: ModuleContext, models) -> dict:
    """Per class model: ``{attr: receiver_name}`` for every ``self.X``
    passed into the constructor of a thread-starting class in this
    module, or into ``Thread(..., args=(self.X,))`` directly."""
    rooted = {m.cls.name for m in models if m.entries}
    out: dict = {}
    for m in models:
        handed: dict = {}
        for method in m.methods.values():
            for node in ast.walk(method):
                if not isinstance(node, ast.Call):
                    continue
                resolved = ctx.resolve(node.func)
                tail = resolved.rsplit(".", 1)[-1] if resolved else None
                if tail in rooted:
                    exprs = list(node.args) + [
                        kw.value for kw in node.keywords
                    ]
                elif tail == "Thread":
                    # the target= method is the entry (threadmodel's
                    # job); shared STATE rides in args=/kwargs=
                    exprs = [
                        kw.value for kw in node.keywords
                        if kw.arg in ("args", "kwargs")
                    ]
                else:
                    continue
                for expr in exprs:
                    for attr in _self_attr_loads(expr):
                        if attr not in m.methods:
                            handed.setdefault(attr, tail)
        out[id(m)] = handed
    return out


def check(ctx: ModuleContext) -> list[Finding]:
    findings: list[Finding] = []
    models = class_models(ctx)
    handed_by_model = _handed_to_thread_roots(ctx, models)

    # ---- thread-shared-mutable, cross-class: an attr handed to another
    # class's thread root is shared with that thread; writes to it here
    # need the same lock the receiver uses — statically unverifiable, so
    # any unlocked post-construction write is flagged.
    for model in models:
        handed = handed_by_model.get(id(model), {})
        if not handed:
            continue
        exempt = model.lock_attrs | model.safe_attrs
        seen: set[tuple] = set()
        for a in model.accesses():
            if (
                a.attr not in handed
                or a.attr in exempt
                or not a.is_write
                or a.locks
            ):
                continue
            key = (a.attr, a.method)
            if key in seen:
                continue
            seen.add(key)
            receiver = handed[a.attr]
            findings.append(Finding(
                RULE_ID, ctx.path, a.node.lineno, a.node.col_offset,
                f"{model.ctx.qualnames.get(model.cls, model.cls.name)}"
                f".{a.method}",
                f"attribute `{a.attr}` is handed to `{receiver}` (which "
                f"runs threads) and written here without a lock — the "
                f"write races the receiver's thread; share one lock "
                f"across both classes, hand over a Queue instead, or "
                f"waive with the reason the handoff is safe",
            ))

    for model in models:
        if not model.thread_using:
            continue
        exempt = model.lock_attrs | model.safe_attrs
        accs = [a for a in model.accesses() if a.attr not in exempt]

        # ---- thread-shared-mutable: cross-root conflicts ----------------
        by_attr: dict[str, list] = {}
        for a in accs:
            by_attr.setdefault(a.attr, []).append(a)
        for attr, attr_accs in sorted(by_attr.items()):
            writes = [a for a in attr_accs if a.is_write]
            if not writes:
                continue
            roots = frozenset().union(*(a.roots for a in attr_accs))
            if len(roots) < 2 or roots == {EXTERNAL}:
                continue    # one root only, or no thread involved
            # a conflict needs a write in one root and any access in
            # another — an attr written and read under the same single
            # root never races
            write_roots = frozenset().union(*(a.roots for a in writes))
            conflicting = [
                a for a in attr_accs if a.roots - write_roots or a.is_write
            ]
            if len(
                frozenset().union(*(a.roots for a in conflicting))
            ) < 2:
                continue
            common = frozenset.intersection(
                *(a.locks for a in conflicting)
            )
            if common:
                continue
            first = min(
                (a for a in conflicting if not a.locks),
                key=lambda a: (a.node.lineno, a.node.col_offset),
                default=conflicting[0],
            )
            methods = sorted({a.method for a in conflicting})
            findings.append(Finding(
                RULE_ID, ctx.path, first.node.lineno,
                first.node.col_offset,
                f"{model.ctx.qualnames.get(model.cls, model.cls.name)}"
                f".{first.method}",
                f"attribute `{attr}` is written on one thread and "
                f"accessed on another ({', '.join(methods)}) with no "
                f"common lock — guard every access with one lock, or "
                f"waive with the reason the publication is safe",
            ))

        # ---- unlocked-rmw: racy increments in externally-callable code --
        seen: set[tuple] = set()
        for a in accs:
            if a.kind != "rmw" or a.locks or EXTERNAL not in a.roots:
                continue
            key = (a.attr, a.method)
            if key in seen:
                continue
            seen.add(key)
            findings.append(Finding(
                RMW_RULE_ID, ctx.path, a.node.lineno, a.node.col_offset,
                f"{model.ctx.qualnames.get(model.cls, model.cls.name)}"
                f".{a.method}",
                f"unlocked read-modify-write of `{a.attr}` in a method "
                f"callable from any thread of a threaded class — "
                f"concurrent callers lose updates",
            ))
    return findings
