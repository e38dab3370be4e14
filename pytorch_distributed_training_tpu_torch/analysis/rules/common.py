"""Shared AST machinery for the lint rules (counterpart: the JAX
package's ``analysis/rules/common.py``, less its traced-scope analysis —
the jit/scan/vmap scopes and their parameter taint — which only the JAX
rules read).

One ``ModuleContext`` is built per file and handed to every rule: parsed
tree, parent links, function qualnames and the import-alias map (``np``
-> ``numpy``).

All of it is deliberately heuristic: the linter's contract is "high-value
findings with a waiver escape hatch", not soundness. Rules err toward
missing exotic constructions over flagging idiomatic host code.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint finding, addressable by (rule, file, symbol) for waivers."""

    rule: str
    path: str  # repo-relative where possible
    line: int
    col: int
    symbol: str  # enclosing function qualname ("" at module level)
    message: str

    def format(self) -> str:
        sym = f" [{self.symbol}]" if self.symbol else ""
        return f"{self.path}:{self.line}:{self.col}: {self.rule}{sym} {self.message}"


def dotted_name(node: ast.AST) -> Optional[str]:
    """``torch.cuda.synchronize`` from the Attribute/Name chain; None if
    not a pure dotted chain."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class ModuleContext:
    def __init__(self, path: str, source: str, tree: ast.Module):
        self.path = path
        self.source = source
        self.tree = tree
        self.parents: dict[ast.AST, ast.AST] = {}
        self.qualnames: dict[ast.AST, str] = {}
        self.aliases: dict[str, str] = {}  # local name -> imported dotted name
        self._functions: list[ast.FunctionDef | ast.AsyncFunctionDef] = []
        self._build()

    # -------------------------------------------------------------- building

    def _build(self) -> None:
        stack: list[tuple[ast.AST, str]] = [(self.tree, "")]
        while stack:
            node, prefix = stack.pop()
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
                qn = prefix
                if isinstance(
                    child,
                    (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef),
                ):
                    qn = f"{prefix}.{child.name}" if prefix else child.name
                    self.qualnames[child] = qn
                    if isinstance(
                        child, (ast.FunctionDef, ast.AsyncFunctionDef)
                    ):
                        self._functions.append(child)
                elif isinstance(child, ast.Import):
                    for a in child.names:
                        self.aliases[a.asname or a.name.split(".")[0]] = (
                            a.name if a.asname else a.name.split(".")[0]
                        )
                elif isinstance(child, ast.ImportFrom) and child.module:
                    for a in child.names:
                        self.aliases[a.asname or a.name] = (
                            f"{child.module}.{a.name}"
                        )
                stack.append((child, qn))

    def functions(self) -> list[ast.FunctionDef | ast.AsyncFunctionDef]:
        return self._functions

    def qualname_of(self, node: ast.AST) -> str:
        """Qualname of the function/class enclosing ``node`` ("" if module
        level)."""
        cur = node
        while cur is not None:
            if cur in self.qualnames:
                return self.qualnames[cur]
            cur = self.parents.get(cur)
        return ""

    def enclosing_function(
        self, node: ast.AST
    ) -> Optional[ast.FunctionDef | ast.AsyncFunctionDef]:
        cur: Optional[ast.AST] = node
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur
            cur = self.parents.get(cur)
        return None

    def resolve(self, node: ast.AST) -> Optional[str]:
        """Dotted name with the leading segment resolved through imports:
        ``np.random.normal`` -> ``numpy.random.normal``; ``Thread`` (from
        ``from threading import Thread``) -> ``threading.Thread``."""
        name = dotted_name(node)
        if name is None:
            return None
        head, _, rest = name.partition(".")
        target = self.aliases.get(head)
        if target is None:
            return name
        return f"{target}.{rest}" if rest else target
