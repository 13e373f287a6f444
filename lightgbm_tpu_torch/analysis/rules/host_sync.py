"""R002: implicit host syncs in the port's hot-path modules.

``t.item()``, ``t.tolist()``, ``t.cpu()``, ``t.numpy()``, ``float(t)``,
``int(t)``, ``bool(t)`` and ``np.asarray(t)`` on a device tensor wait for
the card and copy the value to the host. One of these on the per-wave or
per-iteration path serializes the host with the device every step: the
captured iteration's budget is one flag read per tree (``PERF.md``).
Hoist the read out of the loop, or keep the value on the card.

Scope: functions in ``boosting/``, ``ops/``, ``grower.py``, ``efb.py`` and
``parallel/`` (``serving/`` is R011's), on receivers and arguments that
provably hold device tensors (``rules.common.TensorScope``).

Waiver: a function decorated with ``@allowed_host_sync("<reason>")``
(``lightgbm_tpu_torch.robustness``) is an audited sync point — the
captured iteration's flag read per tree, the streamed wave's per wave, the
checkpoint fetch, the ``nan_policy`` flag fetch, the telemetry publish —
and is skipped.
"""
from __future__ import annotations

import ast

from .common import (PACKAGE, SYNC_BUILTINS, SYNC_NUMPY, dotted_name,
                     function_scope, has_sync_waiver, is_hot_path,
                     iter_functions)

RULE_ID = "R002"

SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}


def sync_calls(fn, scope):
    """(node, description) of each host sync on a device tensor in
    ``fn``."""
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        name = dotted_name(node.func)
        if name in SYNC_BUILTINS | SYNC_NUMPY and node.args:
            if scope.is_tensor(node.args[0]):
                yield node, f"`{name}()`"
        elif isinstance(node.func, ast.Attribute) and \
                node.func.attr in SYNC_METHODS and \
                scope.is_tensor(node.func.value):
            yield node, f"`.{node.func.attr}()`"


class HostSyncRule:
    rule_id = RULE_ID
    summary = ("implicit host sync (.item()/.tolist()/.cpu()/.numpy()/"
               "float(t)/int(t)/bool(t)/np.asarray(t)) on a device tensor "
               "in a hot-path module")

    def check(self, ctx):
        if not is_hot_path(ctx.rel) or f"{PACKAGE}/serving/" in ctx.rel:
            return
        for fn in iter_functions(ctx.tree):
            if has_sync_waiver(fn):
                continue
            scope = function_scope(ctx, fn)
            for node, what in sync_calls(fn, scope):
                if _inner_function(fn, node):
                    continue
                yield ctx.finding(
                    self.rule_id, node,
                    f"{what} on a device tensor in hot-path function "
                    f"`{fn.name}` — an implicit host sync; keep the value "
                    f"on the card, or mark an audited sync point "
                    f"@allowed_host_sync(reason)")


def _inner_function(fn, node) -> bool:
    """``node`` belongs to a function nested in ``fn`` (checked there)."""
    for inner in ast.walk(fn):
        if inner is fn or not isinstance(inner, (ast.FunctionDef,
                                                 ast.AsyncFunctionDef,
                                                 ast.Lambda)):
            continue
        if any(n is node for n in ast.walk(inner)):
            return True
    return False
