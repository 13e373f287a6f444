"""R003: dtype-promotion hazards into device tensors.

Two shapes of silent precision drift in PyTorch:

- a ``torch.stack`` / ``torch.cat`` whose inputs MIX explicit casts
  (``.float()``, ``.double()``, ``.long()``, ``.to(dtype)``) with bare
  names: the bare inputs' dtype is whatever upstream produced, and type
  promotion silently widens (or the op refuses) the whole result — the
  histogram's f32 channels next to an f64 partial change a model's bits
  without an error. Cast every input explicitly.
- a device tensor made from numpy data that took numpy's ``float64``
  default from a Python float (``torch.as_tensor(np.zeros(n))``,
  ``torch.tensor(np.full(n, 0.5), device=dev)``) with no ``dtype=``: in
  arithmetic with the port's f32 tensors it promotes them to f64, doubling
  their bytes and leaving the kernels' f32 contract behind. Give the
  ``dtype`` where the tensor is made.

The deliberate f64 sites (the split scan's prefix sums, B1's scales,
voting's reductions) cast explicitly and stay quiet.
"""
from __future__ import annotations

import ast

from .common import dotted_name, in_package

RULE_ID = "R003"

_STACK_FNS = {"torch.stack", "torch.cat", "torch.concat", "torch.concatenate",
              "torch.hstack", "torch.vstack"}
_CAST_METHODS = {"float", "double", "half", "bfloat16", "long", "int",
                 "short", "bool", "byte", "to", "type"}
_TENSOR_FROM = {"torch.as_tensor", "torch.tensor", "torch.from_numpy",
                "torch.asarray"}
# numpy constructors whose default dtype is float64, with the position of
# their dtype argument
_NP_F64_DEFAULT = {"zeros": 1, "ones": 1, "empty": 1, "full": 2,
                   "linspace": 5, "eye": 3, "array": 1, "asarray": 1,
                   "zeros_like": 1, "ones_like": 1, "full_like": 2,
                   "float64": None}


def _is_cast(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _CAST_METHODS)


def _has_dtype(call: ast.Call) -> bool:
    return any(kw.arg == "dtype" for kw in call.keywords)


def _float_literal(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Constant) and isinstance(n.value, float):
            return True
    return False


def _numpy_f64(node: ast.AST) -> bool:
    """A numpy constructor call that yields float64 by default: no
    ``dtype=``, and for ``array``/``asarray``/``full`` a float literal
    among its values."""
    if not isinstance(node, ast.Call):
        return False
    name = dotted_name(node.func) or ""
    head, _, leaf = name.rpartition(".")
    if head not in ("np", "numpy") or leaf not in _NP_F64_DEFAULT \
            or _has_dtype(node):
        return False
    at = _NP_F64_DEFAULT[leaf]
    if at is not None and len(node.args) > at:
        return False                        # a positional dtype
    if leaf in ("array", "asarray", "full", "full_like"):
        return _float_literal(node)
    return True


class DtypePromotionRule:
    rule_id = RULE_ID
    summary = ("mixed explicit/implicit dtypes into torch.stack/cat, or a "
               "device tensor made from numpy's float64 default without "
               "a dtype (promotes f32 arithmetic to f64)")

    def check(self, ctx):
        if not in_package(ctx.rel):
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            if name in _STACK_FNS and node.args \
                    and isinstance(node.args[0], (ast.List, ast.Tuple)):
                elts = node.args[0].elts
                cast = [e for e in elts if _is_cast(e)]
                bare = [e for e in elts
                        if isinstance(e, (ast.Name, ast.Attribute))]
                if cast and bare:
                    names = ", ".join(sorted(
                        dotted_name(e) or "<expr>" for e in bare))
                    yield ctx.finding(
                        self.rule_id, node,
                        f"`{name}` mixes explicit casts with bare inputs "
                        f"({names}) — type promotion can silently change "
                        f"the result's dtype; cast every input explicitly")
            elif name in _TENSOR_FROM and node.args \
                    and not _has_dtype(node) and _numpy_f64(node.args[0]):
                yield ctx.finding(
                    self.rule_id, node,
                    f"`{name}` of a numpy array in float64 by default "
                    f"(a Python float) with no dtype — in arithmetic with "
                    f"the port's f32 tensors it promotes them to f64; "
                    f"give dtype= where the tensor is made")
