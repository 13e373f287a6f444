"""R001: Python control flow on a device tensor inside a captured part.

``if t:``, ``while t.any():`` and ``assert (t >= 0).all()`` call
``Tensor.__bool__``, which reads the value on the host: a sync on every
call, and inside a part that ``boosting/gbdt._IterationGraphs`` captures it
breaks the capture (a CUDA graph cannot read the card while it records) or,
worse, bakes the branch taken at capture into every replay. Branch on the
device instead (``torch.where``, a masked update), or read the flag once
where the runner reads its flags.

Scope: functions reachable from the captured parts
(``rules.common.CAPTURED_ROOTS``) through the whole-package call graph.
"""
from __future__ import annotations

import ast

from .common import CAPTURED_ROOTS, function_scope, reachable_code

RULE_ID = "R001"


class ControlFlowRule:
    rule_id = RULE_ID
    cross_module = True   # findings depend on the whole-package call graph
    summary = ("Python if/while/assert on a device tensor inside a part a "
               "CUDA graph captures (use torch.where / a masked update)")

    def check(self, ctx):
        for fn in reachable_code(ctx, CAPTURED_ROOTS):
            scope = function_scope(ctx, fn)
            for node in ast.walk(fn):
                if isinstance(node, (ast.If, ast.While, ast.IfExp)):
                    kind = {ast.If: "if", ast.While: "while",
                            ast.IfExp: "if-expression"}[type(node)]
                elif isinstance(node, ast.Assert):
                    kind = "assert"
                else:
                    continue
                if scope.is_tensor(node.test):
                    yield ctx.finding(
                        self.rule_id, node,
                        f"Python `{kind}` on a device tensor in captured "
                        f"code `{fn.name}` — Tensor.__bool__ syncs and "
                        f"breaks (or freezes) the CUDA graph capture; "
                        f"branch on the device with torch.where")
