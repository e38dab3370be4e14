"""Per-class thread/lock model shared by the concurrency lint rules.

(Counterpart: the JAX package's ``analysis/rules/threadmodel.py``,
a copy.)

The JAX rules reason about *traced scopes*; the concurrency rules reason
about *thread roots*: which methods of a class run on a thread the class
itself started (``threading.Thread(target=self._x)``, a ``run`` method on
a Thread subclass) versus the "external" root — methods any other thread
(the constructor's, an HTTP handler's, a test's) may call. One
``ClassThreadModel`` per ``ast.ClassDef`` holds:

- **lock attrs** — ``self.X`` assigned ``threading.Lock/RLock/Condition``
  or the instrumented ``analysis.concurrency`` ``lock()/rlock()``
  factories; holding a Condition counts as holding its lock;
- **safe attrs** — ``self.X`` assigned an object that is thread-safe by
  construction (``Event``, ``queue.Queue``, semaphores, ``deque``):
  method calls on them never need the class's own locking;
- **thread entry methods** and per-method **root sets** (which entries
  reach a method through the intra-class call graph, and whether it is
  externally callable — public name, no intra-class callers, or escaping
  as a bare ``self.m`` reference);
- per-access **held-lock sets**, lexical ``with self.L:`` nesting plus a
  fixpoint over the call graph: a private method whose every call site
  holds ``L`` is analyzed as holding ``L`` (the ``swap_to`` →
  ``_swap_to_locked`` pattern).

Everything here is the same deliberate heuristic contract as
``rules/common.py``: high-value findings with a waiver escape hatch, not
soundness. Per-request-instance classes (HTTP handlers) share no ``self``
across threads and are not modeled as multi-rooted.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Optional

from pytorch_distributed_training_tpu_torch.analysis.rules.common import (
    ModuleContext,
)

# ``self.X = <ctor>()`` patterns establishing lock / thread-safe attrs.
# Matched against the import-resolved dotted name's tail so both
# ``threading.Lock`` and a bare ``Lock`` (from-imported) hit.
_LOCK_TAILS = ("Lock", "RLock", "Condition")
_LOCK_FACTORY_TAILS = ("lock", "rlock")  # analysis.concurrency factories
_SAFE_TAILS = (
    "Event", "Semaphore", "BoundedSemaphore", "Barrier", "local",
    "Queue", "LifoQueue", "PriorityQueue", "SimpleQueue", "deque",
)

#: method names that mutate their receiver in place — ``self.x.append(...)``
#: is a write to the shared container, not a read of the binding
MUTATOR_METHODS = {
    "append", "appendleft", "extend", "extendleft", "add", "remove",
    "discard", "pop", "popleft", "popitem", "clear", "update", "insert",
    "setdefault", "sort", "reverse", "rotate",
}

READ, WRITE, RMW = "read", "write", "rmw"

#: methods whose body never runs concurrently with published state:
#: construction happens-before any thread start
_CONSTRUCTORS = {"__init__", "__post_init__", "__new__"}

EXTERNAL = "external"


@dataclasses.dataclass(frozen=True)
class AttrAccess:
    """One ``self.<attr>`` access inside a method body."""

    attr: str
    kind: str               # read | write | rmw
    method: str
    node: ast.AST
    locks: frozenset        # lock attrs held at this access
    roots: frozenset        # thread roots + "external" reaching the method

    @property
    def is_write(self) -> bool:
        return self.kind in (WRITE, RMW)


def _tail(resolved: Optional[str]) -> Optional[str]:
    if resolved is None:
        return None
    return resolved.rsplit(".", 1)[-1]


def _self_attr(node: ast.AST) -> Optional[str]:
    """``self.X`` -> ``X`` (None for anything else)."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


class ClassThreadModel:
    """The thread/lock view of one class (see module docstring)."""

    def __init__(self, ctx: ModuleContext, cls: ast.ClassDef):
        self.ctx = ctx
        self.cls = cls
        self.methods: dict[str, ast.FunctionDef] = {
            n.name: n
            for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        self.lock_attrs: set[str] = set()
        self.safe_attrs: set[str] = set()
        self.entries: set[str] = set()
        self._callers: dict[str, list[tuple[str, ast.Call]]] = {}
        self._calls: dict[str, set[str]] = {n: set() for n in self.methods}
        self._escapes: set[str] = set()
        self._held: dict[str, dict[int, frozenset]] = {}
        self._scan_attrs()
        self._scan_entries_and_calls()
        self._base_locks = self._fixpoint_base_locks()
        self._roots = self._compute_roots()

    # -------------------------------------------------------------- scanning

    def _classify_ctor(self, value: ast.AST) -> Optional[str]:
        """'lock' / 'safe' when ``value`` constructs one, else None."""
        if not isinstance(value, ast.Call):
            return None
        resolved = self.ctx.resolve(value.func)
        tail = _tail(resolved)
        if tail in _LOCK_TAILS or tail in _LOCK_FACTORY_TAILS:
            return "lock"
        if tail in _SAFE_TAILS:
            return "safe"
        # dataclasses.field(default_factory=Event)
        if tail == "field":
            for kw in value.keywords:
                if kw.arg == "default_factory":
                    t = _tail(self.ctx.resolve(kw.value))
                    if t in _LOCK_TAILS or t in _LOCK_FACTORY_TAILS:
                        return "lock"
                    if t in _SAFE_TAILS:
                        return "safe"
        return None

    def _scan_attrs(self) -> None:
        # self.X = Lock() anywhere in a method body
        for method in self.methods.values():
            for node in ast.walk(method):
                if isinstance(node, ast.Assign) and node.targets:
                    kind = self._classify_ctor(node.value)
                    if kind is None:
                        continue
                    for tgt in node.targets:
                        attr = _self_attr(tgt)
                        if attr is not None:
                            (self.lock_attrs if kind == "lock"
                             else self.safe_attrs).add(attr)
                elif isinstance(node, ast.AnnAssign) and node.value is not None:
                    kind = self._classify_ctor(node.value)
                    attr = _self_attr(node.target)
                    if kind is not None and attr is not None:
                        (self.lock_attrs if kind == "lock"
                         else self.safe_attrs).add(attr)
        # class-level dataclass fields: X: T = field(default_factory=Event)
        for node in self.cls.body:
            if isinstance(node, ast.AnnAssign) and node.value is not None:
                kind = self._classify_ctor(node.value)
                if kind is not None and isinstance(node.target, ast.Name):
                    (self.lock_attrs if kind == "lock"
                     else self.safe_attrs).add(node.target.id)

    def _scan_entries_and_calls(self) -> None:
        bases = {_tail(self.ctx.resolve(b)) or "" for b in self.cls.bases}
        if any("Thread" in b for b in bases) and "run" in self.methods:
            self.entries.add("run")
        for name, method in self.methods.items():
            for node in ast.walk(method):
                if not isinstance(node, ast.Call):
                    continue
                # Thread(target=self.m)
                if _tail(self.ctx.resolve(node.func)) == "Thread":
                    for kw in node.keywords:
                        if kw.arg == "target":
                            tgt = _self_attr(kw.value)
                            if tgt in self.methods:
                                self.entries.add(tgt)
                # self.m(...) intra-class call
                callee = _self_attr(node.func)
                if callee in self.methods:
                    self._calls[name].add(callee)
                    self._callers.setdefault(callee, []).append((name, node))
                # bare self.m reference escaping as an argument/assignment
                for sub in ast.walk(node):
                    if sub is node.func:
                        continue
                    ref = _self_attr(sub)
                    if (
                        ref in self.methods
                        and isinstance(sub, ast.Attribute)
                        and isinstance(sub.ctx, ast.Load)
                    ):
                        self._escapes.add(ref)

    # ------------------------------------------------------------ lock state

    def _held_map(self, name: str) -> dict[int, frozenset]:
        """id(node) -> lexically held lock attrs, for one method body."""
        cached = self._held.get(name)
        if cached is not None:
            return cached
        out: dict[int, frozenset] = {}
        method = self.methods[name]

        def visit(node: ast.AST, held: frozenset) -> None:
            out[id(node)] = held
            if isinstance(node, ast.With):
                acquired = set()
                for item in node.items:
                    out[id(item.context_expr)] = held
                    for sub in ast.walk(item.context_expr):
                        out.setdefault(id(sub), held)
                    attr = _self_attr(item.context_expr)
                    if attr in self.lock_attrs:
                        acquired.add(attr)
                inner = held | frozenset(acquired)
                for stmt in node.body:
                    visit(stmt, inner)
                return
            for child in ast.iter_child_nodes(node):
                if isinstance(
                    child,
                    (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef),
                ):
                    continue
                visit(child, held)

        for stmt in method.body:
            visit(stmt, frozenset())
        self._held[name] = out
        return out

    def _fixpoint_base_locks(self) -> dict[str, frozenset]:
        """Locks a method's body may assume held on entry: the intersection
        over every intra-class call site (private methods only — a public
        name is callable from anywhere with nothing held)."""
        base: dict[str, Optional[frozenset]] = {}
        for name in self.methods:
            if (
                not name.startswith("_")
                or name in self.entries
                or name in self._escapes
                or name not in self._callers
            ):
                base[name] = frozenset()
            else:
                base[name] = None   # derive from call sites
        for _ in range(len(self.methods) + 2):
            changed = False
            for name, cur in base.items():
                if name not in self._callers or base[name] == frozenset():
                    continue
                sites = []
                unresolved = False
                for caller, call in self._callers[name]:
                    cb = base.get(caller)
                    if cb is None:
                        unresolved = True
                        break
                    held = self._held_map(caller).get(id(call), frozenset())
                    sites.append(cb | held)
                if unresolved:
                    continue
                new = frozenset.intersection(*sites) if sites else frozenset()
                if new != cur:
                    base[name] = new
                    changed = True
            if not changed:
                break
        return {n: (b if b is not None else frozenset())
                for n, b in base.items()}

    def locks_at(self, method: str, node: ast.AST) -> frozenset:
        return (
            self._held_map(method).get(id(node), frozenset())
            | self._base_locks.get(method, frozenset())
        )

    # ----------------------------------------------------------------- roots

    def _reach(self, seed: set[str]) -> set[str]:
        out = set(seed)
        frontier = list(seed)
        while frontier:
            m = frontier.pop()
            for callee in self._calls.get(m, ()):
                if callee not in out:
                    out.add(callee)
                    frontier.append(callee)
        return out

    def _compute_roots(self) -> dict[str, frozenset]:
        per_entry = {e: self._reach({e}) for e in self.entries}
        ext_seed = {
            n for n in self.methods
            if n not in self.entries
            and (
                not n.startswith("_")
                or n in self._escapes
                or n not in self._callers
            )
        }
        ext = self._reach(ext_seed)
        roots: dict[str, frozenset] = {}
        for name in self.methods:
            r = {e for e, reach in per_entry.items() if name in reach}
            if name in ext:
                r.add(EXTERNAL)
            roots[name] = frozenset(r)
        return roots

    def roots_of(self, method: str) -> frozenset:
        return self._roots.get(method, frozenset())

    @property
    def thread_using(self) -> bool:
        """Does this class look concurrent at all? (starts threads, or
        owns locks — a lock with no thread would be dead weight)."""
        return bool(self.entries or self.lock_attrs)

    # -------------------------------------------------------------- accesses

    def accesses(self) -> list[AttrAccess]:
        """Every ``self.<attr>`` access outside constructors, classified
        read/write/rmw with held locks and reaching roots."""
        out: list[AttrAccess] = []
        for name, method in self.methods.items():
            if name in _CONSTRUCTORS:
                continue
            roots = self.roots_of(name)
            writes: dict[int, str] = {}     # id(attr node) -> kind

            def mark(node: ast.AST, kind: str) -> None:
                for sub in ast.walk(node):
                    attr = _self_attr(sub)
                    if attr is not None:
                        if writes.get(id(sub)) != RMW:   # RMW is sticky
                            writes[id(sub)] = kind
                    elif (
                        isinstance(sub, ast.Subscript)
                        and _self_attr(sub.value) is not None
                    ):
                        # self.x[i] = ... mutates the container behind x
                        writes[id(sub.value)] = RMW

            body_nodes = []
            stack = list(method.body)
            while stack:
                node = stack.pop()
                if isinstance(
                    node,
                    (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef),
                ):
                    continue
                body_nodes.append(node)
                stack.extend(ast.iter_child_nodes(node))

            for node in body_nodes:
                if isinstance(node, ast.Assign):
                    for t in node.targets:
                        mark(t, WRITE)
                elif isinstance(node, (ast.AnnAssign,)) and node.value:
                    mark(node.target, WRITE)
                elif isinstance(node, ast.AugAssign):
                    mark(node.target, RMW)
                elif isinstance(node, ast.Delete):
                    for t in node.targets:
                        mark(t, WRITE)
                elif isinstance(node, ast.Call):
                    # self.x.append(...): in-place mutation of self.x
                    f = node.func
                    if (
                        isinstance(f, ast.Attribute)
                        and f.attr in MUTATOR_METHODS
                    ):
                        recv = f.value
                        if _self_attr(recv) is not None:
                            writes[id(recv)] = RMW
                        elif (
                            isinstance(recv, ast.Subscript)
                            and _self_attr(recv.value) is not None
                        ):
                            writes[id(recv.value)] = RMW

            for node in body_nodes:
                attr = _self_attr(node)
                if attr is None:
                    continue
                kind = writes.get(id(node))
                if kind is None:
                    if not isinstance(node.ctx, ast.Load):
                        kind = WRITE
                    else:
                        kind = READ
                out.append(AttrAccess(
                    attr=attr, kind=kind, method=name, node=node,
                    locks=self.locks_at(name, node), roots=roots,
                ))
        return out


def class_models(ctx: ModuleContext) -> list[ClassThreadModel]:
    """One model per top-level-ish class in the module (nested classes in
    functions — test fixtures, handler factories — are modeled too)."""
    out = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.ClassDef):
            out.append(ClassThreadModel(ctx, node))
    return out
