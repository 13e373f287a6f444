"""R007: a sort reachable from the wave loop.

A sort on the per-wave path is a fixed cost every wave pays: the failure
the grower's incremental leaf partition removed (a full-N stable sort per
wave; ``grower.py`` keeps the rows leaf-contiguous with counts and prefix
sums instead). New sorts must not creep back into the wave:
``torch.sort`` / ``torch.argsort`` / ``torch.unique`` (and the tensor
methods) reachable from ``TreeGrower.wave`` or the streamed wave's legs
(``StreamedGrower.wave`` / ``_shard_pass``) through the whole-package call
graph fire.

A deliberate sort over a small axis (the ``[L]`` leaf gains) carries an
inline waiver at its call site; the streamed shard step's sort of its rows
to positions (``ops/histogram.pass_positions``, ROADMAP A14b) is recorded
in the baseline until A14b builds the positions without it.
"""
from __future__ import annotations

import ast

from .common import (STREAMED_ROOTS, dotted_name, function_scope,
                     reachable_code)

RULE_ID = "R007"

WAVE_ROOTS = frozenset({("TreeGrower", "wave")}) | STREAMED_ROOTS
_SORT_CALLS = {"torch.sort", "torch.argsort", "torch.unique",
               "torch.unique_consecutive", "torch.msort"}
_SORT_METHODS = {"sort", "argsort", "unique", "unique_consecutive", "msort"}


class SortInLoopRule:
    rule_id = RULE_ID
    cross_module = True   # findings depend on the whole-package call graph
    summary = ("torch.sort/argsort/unique reachable from the wave loop "
               "(TreeGrower.wave, the streamed legs) — a per-wave fixed "
               "cost; derive the grouping from the carried partition")

    def check(self, ctx):
        reported = set()
        for fn in reachable_code(ctx, WAVE_ROOTS):
            scope = function_scope(ctx, fn)
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call) or id(node) in reported:
                    continue
                name = dotted_name(node.func)
                if name in _SORT_CALLS:
                    what = name
                elif isinstance(node.func, ast.Attribute) and \
                        node.func.attr in _SORT_METHODS and \
                        scope.is_tensor(node.func.value):
                    what = f".{node.func.attr}()"
                else:
                    continue
                reported.add(id(node))
                yield ctx.finding(
                    self.rule_id, node,
                    f"`{what}` reachable from the wave loop (via "
                    f"`{fn.name}`) — a sort is a per-wave fixed cost; "
                    f"derive the grouping from the carried partition "
                    f"(counts and prefix sums)")
