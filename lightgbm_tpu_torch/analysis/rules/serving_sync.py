"""R011: unsanctioned host syncs on the serving dispatch path.

The serving engine's latency contract is ONE wait per dispatch: the
stream sync before the result is read from its pinned buffer
(``serving/engine.py``). Any other sync in ``serving/engine.py`` or
``serving/batcher.py`` — a ``torch.cuda.synchronize()`` "to be safe", an
``.item()`` / ``.tolist()`` / ``.cpu()`` on a device value, an
``np.asarray`` of something just computed — serializes the pipeline once
per request, the silent p99 regression the micro-batcher exists to avoid.

What fires, in those two files:

- ``.synchronize()`` on anything but the dispatch's own stream wait, and
  ``torch.cuda.synchronize()`` — always;
- ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()``, ``float(t)``,
  ``int(t)``, ``bool(t)`` on a device tensor (``rules.common
  .TensorScope``);
- ``np.asarray(...)`` / ``np.array(...)`` of a call result or of a name
  assigned from a call that is not numpy's (plausibly a device value).
  Plain input normalization (``np.asarray(X)`` on a parameter) is host
  work and stays legal.

Waiver: the audited sync points carry ``@allowed_host_sync(reason)``.
"""
from __future__ import annotations

import ast

from .common import (PACKAGE, dotted_name, function_scope, has_sync_waiver,
                     iter_functions)
from .host_sync import sync_calls

RULE_ID = "R011"

_SCOPE = (f"{PACKAGE}/serving/engine.py", f"{PACKAGE}/serving/batcher.py")
_NP_MATERIALIZE = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}


def _device_ish_names(fn) -> set:
    """Names assigned (in ``fn``) from a call whose root is not numpy."""
    out = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign) or \
                not isinstance(node.value, ast.Call):
            continue
        callee = dotted_name(node.value.func) or ""
        if callee.startswith(("np.", "numpy.")):
            continue
        for tgt in node.targets:
            if isinstance(tgt, ast.Name):
                out.add(tgt.id)
    return out


class ServingSyncRule:
    rule_id = RULE_ID
    summary = ("unsanctioned host sync (torch.cuda.synchronize / .item / "
               ".cpu / np.asarray of a computed value) in serving/engine.py "
               "or batcher.py — a dispatch waits once, at its result")

    def check(self, ctx):
        rel = ctx.rel.replace("\\", "/")
        if not rel.endswith(_SCOPE):
            return
        for fn in iter_functions(ctx.tree):
            if has_sync_waiver(fn):
                continue
            scope = function_scope(ctx, fn)
            device_ish = _device_ish_names(fn)
            flagged = set()
            for node, what in sync_calls(fn, scope):
                flagged.add(id(node))
                yield ctx.finding(
                    self.rule_id, node,
                    f"{what} on a device tensor in serving code `{fn.name}` "
                    f"— a per-request host sync outside the dispatch's "
                    f"one result wait")
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call) or id(node) in flagged:
                    continue
                name = dotted_name(node.func) or ""
                if name == "torch.cuda.synchronize" or (
                        isinstance(node.func, ast.Attribute)
                        and node.func.attr == "synchronize"
                        and name != "torch.cuda.synchronize"):
                    yield ctx.finding(
                        self.rule_id, node,
                        f"`{name or '.synchronize'}()` in serving code "
                        f"`{fn.name}` — a device wait outside the "
                        f"dispatch's one result wait")
                elif name in _NP_MATERIALIZE and node.args:
                    arg = node.args[0]
                    if isinstance(arg, ast.Call) or (
                            isinstance(arg, ast.Name)
                            and arg.id in device_ish):
                        yield ctx.finding(
                            self.rule_id, node,
                            f"`{name}()` on a just-computed value in "
                            f"serving code `{fn.name}` — if that value "
                            f"lives on the card this is a hidden "
                            f"per-request sync")
