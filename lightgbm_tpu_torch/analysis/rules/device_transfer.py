"""R009: host-device transfers inside a captured part.

A part that ``boosting/gbdt._IterationGraphs`` captures must read nothing
from the host and write no host value: a ``.to(device)`` / ``.cuda()`` of
host data, a ``torch.tensor(...)`` / ``torch.as_tensor(...)`` of host
values, and **item assignment of a Python scalar into a device tensor**
(``t[i] = 0.5``, which copies a host tensor onto the card) either bake the
value seen at capture into every replay or fail the capture (ROADMAP
hazard "a captured part must not write a host scalar"). Write constants
on the card (``fill_``, ``index_fill_``, a ``torch.where`` against a
device scalar made once outside the capture).

Scope: functions reachable from the captured parts
(``rules.common.CAPTURED_ROOTS``: the iteration's parts and
``TreeGrower.wave``) through the whole-package call graph. The streamed
wave's copies have one home, ``ops/stream.ShardPrefetcher``, outside any
capture.
"""
from __future__ import annotations

import ast

from .common import (CAPTURED_ROOTS, dotted_name, function_scope,
                     reachable_code)

RULE_ID = "R009"

_FROM_HOST = {"torch.tensor", "torch.as_tensor", "torch.from_numpy",
              "torch.asarray"}
_DTYPES = {"float16", "float32", "float64", "bfloat16", "half", "float",
           "double", "int8", "int16", "int32", "int64", "uint8", "bool",
           "long", "int", "short", "uint16", "uint32", "uint64",
           "complex64", "complex128"}


def _is_dtype(node: ast.AST, aliases=frozenset()) -> bool:
    name = dotted_name(node) or ""
    return name.startswith("torch.") and name.split(".")[-1] in _DTYPES \
        or name.endswith(".dtype") or name in aliases


def dtype_aliases(*scopes) -> set:
    """Names bound to a dtype (``i32 = torch.int32``, ``dt = x.dtype``)
    in the given module or function nodes."""
    out = set()
    for scope in scopes:
        for node in ast.walk(scope):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                pairs = []
                t, v = node.targets[0], node.value
                if isinstance(t, ast.Name):
                    pairs = [(t, v)]
                elif isinstance(t, ast.Tuple) and \
                        isinstance(v, ast.Tuple) and \
                        len(t.elts) == len(v.elts):
                    pairs = zip(t.elts, v.elts)
                for tn, vn in pairs:
                    if isinstance(tn, ast.Name) and _is_dtype(vn):
                        out.add(tn.id)
    return out


def _moves_device(call: ast.Call, aliases) -> bool:
    """``t.to(...)`` with a device: any ``device=`` keyword, or a first
    argument that is not a dtype (``torch.device(...)``, ``dev``,
    ``"cuda"``, ``other.device``, another tensor)."""
    if any(kw.arg == "device" for kw in call.keywords):
        return True
    return bool(call.args) and not _is_dtype(call.args[0], aliases)


def _host_scalar(node: ast.AST) -> bool:
    if isinstance(node, ast.UnaryOp):
        node = node.operand
    return isinstance(node, ast.Constant) and \
        isinstance(node.value, (int, float, bool))


class DeviceTransferRule:
    rule_id = RULE_ID
    cross_module = True   # findings depend on the whole-package call graph
    summary = (".to(device)/.cuda()/torch.tensor(host data) or `t[i] = "
               "<Python scalar>` inside a part a CUDA graph captures — a "
               "host value baked into (or breaking) the capture")

    def check(self, ctx):
        reported = set()
        module_dtypes = dtype_aliases(*[s for s in ctx.tree.body
                                        if isinstance(s, ast.Assign)])
        for fn in reachable_code(ctx, CAPTURED_ROOTS):
            scope = function_scope(ctx, fn)
            dtypes = module_dtypes | dtype_aliases(fn)
            for node in ast.walk(fn):
                if id(node) in reported:
                    continue
                msg = None
                if isinstance(node, ast.Call):
                    name = dotted_name(node.func)
                    if name in _FROM_HOST:
                        msg = (f"`{name}(...)` makes a tensor from host "
                               f"data")
                    elif isinstance(node.func, ast.Attribute) and \
                            scope.is_tensor(node.func.value):
                        if node.func.attr == "cuda" or (
                                node.func.attr == "to"
                                and _moves_device(node, dtypes)):
                            msg = (f"`.{node.func.attr}(...)` moves a "
                                   f"tensor between devices")
                elif isinstance(node, ast.Assign):
                    for t in node.targets:
                        if isinstance(t, ast.Subscript) and \
                                scope.is_tensor(t.value) and \
                                _host_scalar(node.value):
                            msg = (f"`{ast.unparse(t)} = "
                                   f"{ast.unparse(node.value)}` writes a "
                                   f"Python scalar into a device tensor "
                                   f"(a host-to-device copy)")
                if msg is None:
                    continue
                reported.add(id(node))
                yield ctx.finding(
                    self.rule_id, node,
                    f"{msg} in captured code `{fn.name}` — the replay "
                    f"keeps the value seen at capture, or the capture "
                    f"fails; write it on the card (fill_, index_fill_, a "
                    f"device scalar made outside the capture)")
