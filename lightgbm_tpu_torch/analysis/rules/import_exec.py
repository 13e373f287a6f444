"""R006: device work at module import time.

A ``torch.zeros(...)`` / ``torch.arange(...)`` / ``torch.cuda.*(...)``
call at module scope runs when the module is imported: a
``torch.cuda.*`` call initialises CUDA in every process that imports the
port — the CPU tests, the lint CLI, a rank that has not picked its card
yet (``config.resolve_device``), a forked worker that then cannot use
CUDA — and a tensor made there lands on whatever device is current.
Build tensors lazily inside the function that needs them. ``torch.device``,
``torch.finfo`` and dtype attributes are not device work and stay fine.

``if __name__ == "__main__":`` blocks run at script time, not import, and
are exempt.
"""
from __future__ import annotations

import ast

from .common import dotted_name, in_package, is_tensor_call_name

RULE_ID = "R006"


def _walk_skipping_functions(root):
    """ast.walk that never descends into function/lambda bodies — code in
    there runs at call time, not import time."""
    stack = [root]
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.Lambda, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _is_main_guard(stmt) -> bool:
    return (isinstance(stmt, ast.If)
            and isinstance(stmt.test, ast.Compare)
            and isinstance(stmt.test.left, ast.Name)
            and stmt.test.left.id == "__name__")


def _device_work(name: str) -> bool:
    return name.startswith("torch.cuda.") or is_tensor_call_name(name)


class ImportExecRule:
    rule_id = RULE_ID
    summary = ("torch tensor creation or torch.cuda.* call at module import "
               "time (initialises CUDA in every importer)")

    def _walk_module_level(self, stmts):
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if _is_main_guard(stmt):
                continue
            yield stmt
            for attr in ("body", "orelse", "finalbody"):
                inner = getattr(stmt, attr, None)
                if inner:
                    yield from self._walk_module_level(inner)
            for h in getattr(stmt, "handlers", ()):
                yield from self._walk_module_level(h.body)

    def check(self, ctx):
        if not in_package(ctx.rel):
            return
        for stmt in self._walk_module_level(ctx.tree.body):
            if isinstance(stmt, (ast.If, ast.Try, ast.With, ast.For,
                                 ast.While, ast.ClassDef)):
                exprs = []
                if isinstance(stmt, (ast.If, ast.While)):
                    exprs = [stmt.test]
                elif isinstance(stmt, ast.With):
                    exprs = [i.context_expr for i in stmt.items]
                elif isinstance(stmt, ast.For):
                    exprs = [stmt.iter]
            else:
                exprs = [stmt]
            for expr in exprs:
                for node in _walk_skipping_functions(expr):
                    if not isinstance(node, ast.Call):
                        continue
                    name = dotted_name(node.func) or ""
                    if _device_work(name):
                        yield ctx.finding(
                            self.rule_id, node,
                            f"`{name}(...)` runs at module import time — "
                            f"it makes a tensor or initialises CUDA in "
                            f"every process that imports the module; build "
                            f"it lazily inside the function that uses it")
