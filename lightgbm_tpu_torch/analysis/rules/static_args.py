"""R005: rebinding a buffer the CUDA graphs read.

The JAX package's R005 caught unhashable ``static_argnums``: a value jit
hashes per call, which recompiles or raises. Its counterpart in the port
is the address a captured graph holds. ``boosting/gbdt._IterationGraphs``
captures the iteration's parts once and replays them against the buffers
they saw (the booster's scores, the grower's state, the stacked trees): a
part that rebinds such a tensor (``self.score = new``, ``st.leaf_id =
...``) instead of writing into it (``self.score.copy_(new)``) leaves every
later replay reading and writing the old buffer, and the model silently
stops learning from that field (ROADMAP hazard "graphs read fixed
addresses").

Flagged: inside functions reachable from the captured parts
(``rules.common.CAPTURED_ROOTS``), an assignment (``=``, not the in-place
``+=``) to ``self.x`` where ``x`` is a tensor field of the class, or to
``obj.x`` where ``obj`` holds a package class with tensor field ``x``.
An intentional rebind outside any capture (the first eager tree's
allocation) belongs in the baseline with its reason.
"""
from __future__ import annotations

import ast

from .common import CAPTURED_ROOTS, function_scope, package_index, \
    reachable_code

RULE_ID = "R005"


class BufferRebindRule:
    rule_id = RULE_ID
    cross_module = True   # findings depend on the whole-package call graph
    summary = ("a tensor field rebound (`self.x = ...`) inside a part a "
               "CUDA graph captures — the replays keep the old address; "
               "write into it with .copy_()")

    def check(self, ctx):
        index = package_index(ctx)
        for fn in reachable_code(ctx, CAPTURED_ROOTS):
            scope = function_scope(ctx, fn)
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign):
                    targets = node.targets
                elif isinstance(node, ast.AnnAssign) and node.value:
                    targets = [node.target]
                else:
                    continue
                for t in targets:
                    for el in (t.elts if isinstance(t, (ast.Tuple, ast.List))
                               else [t]):
                        if not isinstance(el, ast.Attribute):
                            continue
                        owner = scope.type_of(el.value)
                        if owner is None or \
                                el.attr not in index.fields(owner):
                            continue
                        what = ast.unparse(el)
                        yield ctx.finding(
                            self.rule_id, node,
                            f"`{what} = ...` rebinds a tensor in captured "
                            f"code `{fn.name}` — a CUDA graph replays "
                            f"against the address it captured; write into "
                            f"the buffer (`{what}.copy_(...)`) instead")
