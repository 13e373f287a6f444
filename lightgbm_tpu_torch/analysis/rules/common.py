"""Shared AST helpers for the torch-lint rules.

The port of ``lightgbm_tpu/analysis/rules/common.py``. Where the JAX
package asks "is this value traced under jit?", the port asks "does this
name hold a device tensor?", and where it walks from ``lax.while_loop``
bodies, the port walks from the parts of an iteration a CUDA graph
captures. Both stay conservative: a value is a tensor only when it
demonstrably flows from one, so host-side numpy code in the same files
stays quiet, and the baseline absorbs the audited remainder.

- **Tensor inference** (:class:`TensorScope`): a name holds a tensor when
  it is assigned from a ``torch.*`` call that returns one, from a tensor
  method (``t.sum()``, ``t[i]``, arithmetic on a tensor), or from a field
  of an object whose class is known: ``self.x`` where the class assigns a
  tensor to ``self.x`` or annotates it ``torch.Tensor``, and one level
  through a typed attribute (``self.state.flags``, ``GrowState.flags:
  torch.Tensor``). Shapes, dtypes, ``.numel()``, ``.item()`` and friends
  are host values.
- **Hot paths**: ``boosting/``, ``ops/``, ``grower.py``, ``efb.py``,
  ``serving/``, ``parallel/`` of the port.
- **Captured parts** (:data:`CAPTURED_ROOTS`): ``GBDT._part_start``,
  ``_part_tree``, ``_part_tree_end`` and ``TreeGrower.wave`` — the code
  ``boosting/gbdt._IterationGraphs`` captures — and what they call within
  the package, through the whole-package call graph
  (:class:`PackageIndex`): module functions through imports, ``self.m()``
  in the class and its bases, and ``self.x.m()`` where ``self.x`` holds an
  instance of a package class.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, Iterable, List, Optional, Set, Tuple

PACKAGE = "lightgbm_tpu_torch"

HOT_PATH_MARKERS = (f"{PACKAGE}/boosting/", f"{PACKAGE}/ops/",
                    f"{PACKAGE}/serving/", f"{PACKAGE}/parallel/")
HOT_PATH_FILES = (f"{PACKAGE}/grower.py", f"{PACKAGE}/efb.py")

# (class, method) pairs a CUDA graph captures (boosting/gbdt.py
# _IterationGraphs: start, per model tree and end, and the wave)
CAPTURED_ROOTS = frozenset({("GBDT", "_part_start"), ("GBDT", "_part_tree"),
                            ("GBDT", "_part_tree_end"),
                            ("TreeGrower", "wave")})
# the streamed wave and its per-shard legs (grower.StreamedGrower)
STREAMED_ROOTS = frozenset({("StreamedGrower", "wave"),
                            ("StreamedGrower", "_shard_pass")})

# torch namespaces whose calls return tensors
_TENSOR_NAMESPACES = ("torch.nn.functional.", "torch.linalg.",
                      "torch.special.", "torch.fft.")
# torch.* calls that return no tensor (types, state, context managers)
_NON_TENSOR_TORCH = {
    "device", "dtype", "Size", "finfo", "iinfo", "Generator", "is_tensor",
    "is_floating_point", "is_complex", "numel", "equal", "allclose",
    "no_grad", "inference_mode", "enable_grad", "manual_seed", "seed",
    "initial_seed", "is_grad_enabled", "compile", "result_type",
    "promote_types", "can_cast", "get_default_dtype", "is_nonzero",
    "typename", "is_storage", "broadcast_shapes", "save", "load",
}
# tensor methods and attributes whose value lives on the host
HOST_METHODS = {"item", "tolist", "numpy", "size", "dim", "numel",
                "element_size", "data_ptr", "is_contiguous", "stride",
                "storage_offset", "get_device", "nelement", "ndimension",
                "is_pinned", "untyped_storage", "equal", "is_floating_point",
                "is_complex", "__len__", "type", "is_set_to", "allclose"}
HOST_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda", "layout",
              "requires_grad", "names", "is_sparse", "itemsize", "nbytes",
              "is_leaf", "grad_fn"}
# Python constructs that read a tensor on the host
SYNC_BUILTINS = {"float", "int", "bool"}
SYNC_NUMPY = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}


def dotted_name(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def iter_functions(tree: ast.AST) -> Iterable[ast.FunctionDef]:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def in_package(rel: str) -> bool:
    rel = rel.replace("\\", "/")
    return f"{PACKAGE}/" in rel or rel.startswith(PACKAGE)


def is_hot_path(rel: str) -> bool:
    rel = rel.replace("\\", "/")
    if any(m in rel for m in HOT_PATH_MARKERS):
        return True
    return any(rel.endswith(f) for f in HOT_PATH_FILES)


def has_sync_waiver(fn) -> bool:
    """True when ``fn`` carries the ``allowed_host_sync`` decorator (bare or
    dotted, called with a reason)."""
    for dec in getattr(fn, "decorator_list", ()):
        target = dec.func if isinstance(dec, ast.Call) else dec
        name = dotted_name(target)
        if name and name.split(".")[-1] == "allowed_host_sync":
            return True
    return False


def is_tensor_call_name(name: Optional[str]) -> bool:
    """A dotted ``torch.*`` call that returns a tensor."""
    if not name or not name.startswith("torch."):
        return False
    if name.startswith(_TENSOR_NAMESPACES):
        return True
    rest = name[len("torch."):]
    return "." not in rest and rest not in _NON_TENSOR_TORCH \
        and not rest.startswith(("set_", "get_", "is_", "use_"))


def is_annotated_tensor(ann: ast.AST) -> bool:
    """``torch.Tensor`` / ``Tensor`` / ``Optional[torch.Tensor]``."""
    for n in ast.walk(ann):
        if isinstance(n, ast.Attribute) and n.attr == "Tensor":
            return True
        if isinstance(n, ast.Name) and n.id == "Tensor":
            return True
        if isinstance(n, ast.Constant) and isinstance(n.value, str) \
                and n.value.endswith("Tensor"):
            return True
    return False


def _assign_targets(stmt: ast.AST) -> List[ast.AST]:
    out = []

    def collect(t):
        if isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                collect(e)
        else:
            out.append(t)

    if isinstance(stmt, ast.Assign):
        for t in stmt.targets:
            collect(t)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        collect(stmt.target)
    return out


def self_attr(node: ast.AST) -> Optional[str]:
    """'x' for a ``self.x`` attribute node, else None."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


# ---------------------------------------------------------------- modules

class ModuleInfo:
    """Per-file slice of the package call graph: top-level defs, classes
    (methods, bases, tensor fields, typed attributes) and the two import
    maps."""

    def __init__(self, path: str, rel: str, tree: ast.Module):
        self.path = path
        self.rel = rel
        self.tree = tree
        self.modname = _modname_for_rel(rel)
        self.defs: Dict[str, ast.FunctionDef] = {}
        self.classes: Dict[str, Dict[str, ast.FunctionDef]] = {}
        self.class_nodes: Dict[str, ast.ClassDef] = {}
        self.import_modules: Dict[str, str] = {}
        self.import_names: Dict[str, Tuple[str, str]] = {}
        # id(fn) -> enclosing ClassDef name (innermost)
        self.owner_class: Dict[int, str] = {}
        self._index_defs()
        self._index_imports()

    def _index_defs(self) -> None:
        def visit(node: ast.AST, cls: Optional[str]) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    if cls is None:
                        self.defs.setdefault(child.name, child)
                    else:
                        self.classes.setdefault(cls, {}).setdefault(
                            child.name, child)
                        self.owner_class[id(child)] = cls
                    visit(child, cls)
                elif isinstance(child, ast.ClassDef):
                    self.class_nodes.setdefault(child.name, child)
                    self.classes.setdefault(child.name, {})
                    visit(child, child.name)
                else:
                    visit(child, cls)

        visit(self.tree, None)

    def _index_imports(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.asname:
                        self.import_modules[alias.asname] = alias.name
                    else:
                        head = alias.name.split(".")[0]
                        self.import_modules[head] = head
            elif isinstance(node, ast.ImportFrom):
                src = self._resolve_from(node)
                if src is None:
                    continue
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    self.import_names[alias.asname or alias.name] = \
                        (src, alias.name)

    def _resolve_from(self, node: ast.ImportFrom) -> Optional[str]:
        if node.level == 0:
            return node.module
        parts = self.modname.split(".")
        if self.rel.endswith("__init__.py"):
            parts = parts + ["__init__"]
        if len(parts) < node.level:
            return node.module
        base = parts[:-node.level]
        if node.module:
            base = base + node.module.split(".")
        return ".".join(base) if base else node.module


def _modname_for_rel(rel: str) -> str:
    norm = rel.replace(os.sep, "/")
    if norm.endswith(".py"):
        norm = norm[:-3]
    if norm.endswith("/__init__"):
        norm = norm[: -len("/__init__")]
    return norm.replace("/", ".")


ClassKey = Tuple[str, str]          # (module name, class name)


class PackageIndex:
    """Whole-package call graph and class model over every file of one lint
    run. Modules are matched by dotted suffix; reachability from a set of
    (class, method) roots is a cross-module walk cached per root set."""

    def __init__(self, modules: List[ModuleInfo]):
        self.modules: Dict[str, ModuleInfo] = {}
        self.by_path: Dict[str, ModuleInfo] = {}
        self._by_tail: Dict[str, List[ModuleInfo]] = {}
        for m in modules:
            self.modules[m.modname] = m
            self.by_path[m.rel] = m
            self._by_tail.setdefault(m.modname.rsplit(".", 1)[-1],
                                     []).append(m)
        self._module_cache: Dict[Tuple[str, str], Optional[ModuleInfo]] = {}
        self._reach_cache: Dict[frozenset, Dict[int, Tuple[ModuleInfo,
                                                           ast.AST]]] = {}
        self._fields: Dict[ClassKey, Set[str]] = {}
        self._attr_types: Dict[ClassKey, Dict[str, ClassKey]] = {}
        self._built_classes = False

    @classmethod
    def build(cls, files: Iterable[Tuple[str, str, ast.Module]]
              ) -> "PackageIndex":
        return cls([ModuleInfo(p, r, t) for p, r, t in files])

    # ------------------------------------------------------------ modules

    def find_module(self, dotted: Optional[str],
                    near: Optional[ModuleInfo] = None
                    ) -> Optional[ModuleInfo]:
        if not dotted:
            return None
        key = (dotted, near.modname if near else "")
        if key not in self._module_cache:
            self._module_cache[key] = self._find_module(dotted, near)
        return self._module_cache[key]

    def _find_module(self, dotted: str, near: Optional[ModuleInfo]
                     ) -> Optional[ModuleInfo]:
        if dotted in self.modules:
            return self.modules[dotted]
        tail = dotted.split(".")[-1]
        cands = [m for m in self._by_tail.get(tail, ())
                 if m.modname == dotted or m.modname.endswith("." + dotted)
                 or dotted.endswith("." + m.modname)]
        if not cands:
            return None
        if len(cands) == 1 or near is None:
            return cands[0]

        def score(m: ModuleInfo) -> int:
            a, b = m.modname.split("."), near.modname.split(".")
            n = 0
            while n < min(len(a), len(b)) and a[n] == b[n]:
                n += 1
            return n
        return max(cands, key=score)

    # ------------------------------------------------------------ classes

    def resolve_class(self, mod: ModuleInfo, name: Optional[str]
                      ) -> Optional[ClassKey]:
        """A (possibly dotted) class reference in ``mod`` bound to a class
        of the package."""
        if not name:
            return None
        parts = name.split(".")
        if len(parts) == 1:
            if name in mod.class_nodes:
                return (mod.modname, name)
            if name in mod.import_names:
                src, attr = mod.import_names[name]
                tm = self.find_module(src, near=mod)
                if tm and attr in tm.class_nodes:
                    return (tm.modname, attr)
            return None
        head, rest = parts[0], parts[1:]
        base = mod.import_modules.get(head)
        if base is None and head in mod.import_names:
            base = ".".join(mod.import_names[head])
        if base is None:
            return None
        tm = self.find_module(".".join([base] + rest[:-1]), near=mod)
        if tm and rest[-1] in tm.class_nodes:
            return (tm.modname, rest[-1])
        return None

    def class_node(self, key: ClassKey) -> Optional[ast.ClassDef]:
        m = self.modules.get(key[0])
        return m.class_nodes.get(key[1]) if m else None

    def bases(self, key: ClassKey) -> List[ClassKey]:
        """The class and its package bases, nearest first."""
        out, todo = [], [key]
        while todo:
            k = todo.pop(0)
            if k in out:
                continue
            out.append(k)
            node, mod = self.class_node(k), self.modules.get(k[0])
            if node is None or mod is None:
                continue
            for b in node.bases:
                bk = self.resolve_class(mod, dotted_name(b))
                if bk is not None:
                    todo.append(bk)
        return out

    def _build_classes(self) -> None:
        """Tensor fields and typed attributes of every class: annotated
        ``torch.Tensor`` fields, ``self.x = <tensor>`` and ``self.x =
        Cls(...)`` in any method (a fixpoint, since a field's tensor-ness
        feeds the next method's inference)."""
        if self._built_classes:
            return
        self._built_classes = True
        for mod in self.modules.values():
            for cname, node in mod.class_nodes.items():
                key = (mod.modname, cname)
                fields = self._fields.setdefault(key, set())
                types = self._attr_types.setdefault(key, {})
                for item in node.body:
                    if isinstance(item, ast.AnnAssign) and \
                            isinstance(item.target, ast.Name) and \
                            is_annotated_tensor(item.annotation):
                        fields.add(item.target.id)
                for fn in mod.classes.get(cname, {}).values():
                    for st in ast.walk(fn):
                        if isinstance(st, ast.AnnAssign):
                            a = self_attr(st.target)
                            if a and is_annotated_tensor(st.annotation):
                                fields.add(a)
                        if isinstance(st, ast.Assign) and \
                                isinstance(st.value, ast.Call):
                            ck = self.resolve_class(
                                mod, dotted_name(st.value.func))
                            if ck is None:
                                continue
                            for t in _assign_targets(st):
                                a = self_attr(t)
                                if a:
                                    types[a] = ck
        for _ in range(3):
            changed = False
            for mod in self.modules.values():
                for cname in mod.class_nodes:
                    key = (mod.modname, cname)
                    for fn in mod.classes.get(cname, {}).values():
                        scope = TensorScope(self, mod, fn)
                        for st in ast.walk(fn):
                            if not isinstance(st, (ast.Assign,
                                                   ast.AnnAssign)):
                                continue
                            if st.value is None or \
                                    not scope.is_tensor(st.value):
                                continue
                            for t in _assign_targets(st):
                                a = self_attr(t)
                                if a and a not in self._fields[key]:
                                    self._fields[key].add(a)
                                    changed = True
            if not changed:
                break

    def fields(self, key: ClassKey) -> Set[str]:
        self._build_classes()
        out: Set[str] = set()
        for k in self.bases(key):
            out |= self._fields.get(k, set())
        return out

    def attr_type(self, key: ClassKey, attr: str) -> Optional[ClassKey]:
        self._build_classes()
        for k in self.bases(key):
            t = self._attr_types.get(k, {}).get(attr)
            if t is not None:
                return t
        return None

    def find_classes(self, name: str) -> List[ClassKey]:
        return [(m.modname, name) for m in self.modules.values()
                if name in m.class_nodes]

    # ---------------------------------------------------------- resolution

    def resolve(self, mod: ModuleInfo, dotted: str
                ) -> List[Tuple[ModuleInfo, ast.FunctionDef]]:
        """Best-effort binding of a (possibly dotted) callable reference in
        ``mod`` to function defs anywhere in the package."""
        parts = dotted.split(".")
        head, rest = parts[0], parts[1:]
        if not rest:
            if head in mod.defs:
                return [(mod, mod.defs[head])]
            if head in mod.import_names:
                src, attr = mod.import_names[head]
                tm = self.find_module(src, near=mod)
                if tm and attr in tm.defs:
                    return [(tm, tm.defs[attr])]
            return []
        out: List[Tuple[ModuleInfo, ast.FunctionDef]] = []
        if head in mod.import_modules:
            tm = self.find_module(
                ".".join([mod.import_modules[head]] + rest[:-1]), near=mod)
            if tm and rest[-1] in tm.defs:
                out.append((tm, tm.defs[rest[-1]]))
        if head in mod.import_names:
            src, attr = mod.import_names[head]
            tm = self.find_module(".".join([src, attr] + rest[:-1]),
                                  near=mod)
            if tm and rest[-1] in tm.defs:
                out.append((tm, tm.defs[rest[-1]]))
        return out

    def method(self, key: ClassKey, name: str
               ) -> List[Tuple[ModuleInfo, ast.FunctionDef]]:
        """``name`` in the class or its nearest package base."""
        for k in self.bases(key):
            mod = self.modules.get(k[0])
            fn = mod.classes.get(k[1], {}).get(name) if mod else None
            if fn is not None:
                return [(mod, fn)]
        return []

    def resolve_self_call(self, mod: ModuleInfo, fn, dotted: str
                          ) -> List[Tuple[ModuleInfo, ast.FunctionDef]]:
        """``self.m(...)`` -> the class's method; ``self.x.m(...)`` -> the
        method of the class ``self.x`` holds."""
        cls = mod.owner_class.get(id(fn))
        if cls is None:
            return []
        parts = dotted.split(".")[1:]
        key = (mod.modname, cls)
        if len(parts) == 1:
            return self.method(key, parts[0])
        if len(parts) == 2:
            t = self.attr_type(key, parts[0])
            if t is not None:
                return self.method(t, parts[1])
        return []

    # --------------------------------------------------------- reachability

    def reachable_from(self, roots: frozenset
                       ) -> Dict[int, Tuple[ModuleInfo, ast.AST]]:
        """Every function reachable from the ``(class, method)`` roots,
        across module boundaries, keyed by ``id(fn)``."""
        cached = self._reach_cache.get(roots)
        if cached is not None:
            return cached
        frontier: List[Tuple[ModuleInfo, ast.AST]] = []
        for cname, meth in roots:
            for key in self.find_classes(cname):
                mod = self.modules[key[0]]
                fn = mod.classes.get(cname, {}).get(meth)
                if fn is not None:
                    frontier.append((mod, fn))
        seen: Dict[int, Tuple[ModuleInfo, ast.AST]] = {}
        while frontier:
            mod, fn = frontier.pop()
            if id(fn) in seen:
                continue
            seen[id(fn)] = (mod, fn)
            local = _all_defs(mod.tree)
            for name in referenced_callables(fn):
                if "." not in name and name in local:
                    frontier.append((mod, local[name]))
                    continue
                if name.startswith("self."):
                    frontier.extend(self.resolve_self_call(mod, fn, name))
                    continue
                frontier.extend(self.resolve(mod, name))
        self._reach_cache[roots] = seen
        return seen


def referenced_callables(fn) -> Set[str]:
    """Names (bare and dotted) this function's body may call or forward,
    ``functools.partial(self.m, ...)`` included."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Attribute):
            name = dotted_name(node)
            if name:
                out.add(name)
        elif isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            out.add(node.id)
    return out


def _all_defs(tree: ast.Module) -> Dict[str, ast.FunctionDef]:
    out: Dict[str, ast.FunctionDef] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.setdefault(node.name, node)
    return out


def package_index(ctx) -> PackageIndex:
    """The run's index (``ctx.package``), or a one-module index when a file
    is linted alone."""
    index = getattr(ctx, "package", None)
    if index is None:
        index = PackageIndex.build([(ctx.path, ctx.rel, ctx.tree)])
        ctx.package = index
    return index


def reachable_code(ctx, roots: frozenset) -> List[ast.AST]:
    """Functions reachable from ``roots`` that live in ``ctx``'s file."""
    index = package_index(ctx)
    mod = index.by_path.get(ctx.rel)
    if mod is None:
        return []
    return [fn for (m, fn) in index.reachable_from(roots).values()
            if m is mod]


def function_scope(ctx, fn) -> "TensorScope":
    index = package_index(ctx)
    return TensorScope(index, index.by_path[ctx.rel], fn)


# -------------------------------------------------------- tensor inference

class TensorScope:
    """Which expressions of one function hold device tensors (module
    docstring). Names are inferred by a fixpoint over the function's
    assignments; ``self`` is the enclosing class."""

    def __init__(self, index: PackageIndex, mod: ModuleInfo, fn):
        self.index = index
        self.mod = mod
        cls = mod.owner_class.get(id(fn))
        self.cls: Optional[ClassKey] = (mod.modname, cls) if cls else None
        self.names: Set[str] = set()
        self.types: Dict[str, ClassKey] = {}
        assigns = [s for s in ast.walk(fn)
                   if isinstance(s, (ast.Assign, ast.AnnAssign, ast.For,
                                     ast.With))]
        for s in assigns:
            if isinstance(s, ast.AnnAssign) and \
                    isinstance(s.target, ast.Name) and \
                    is_annotated_tensor(s.annotation):
                self.names.add(s.target.id)
        args = fn.args
        for a in args.posonlyargs + args.args + args.kwonlyargs:
            if a.annotation is not None and is_annotated_tensor(a.annotation):
                self.names.add(a.arg)
            elif a.annotation is not None:
                ck = index.resolve_class(mod, dotted_name(a.annotation))
                if ck is not None:
                    self.types[a.arg] = ck
        changed = True
        while changed:
            changed = False
            for s in assigns:
                if isinstance(s, (ast.For, ast.With)) or s.value is None:
                    continue
                tensor = self.is_tensor(s.value)
                typ = self.type_of(s.value)
                for t in _assign_targets(s):
                    if not isinstance(t, ast.Name):
                        continue
                    if tensor and t.id not in self.names:
                        self.names.add(t.id)
                        changed = True
                    if typ is not None and t.id not in self.types:
                        self.types[t.id] = typ
                        changed = True

    def type_of(self, node: ast.AST) -> Optional[ClassKey]:
        """The package class an expression holds an instance of."""
        if isinstance(node, ast.Name):
            if node.id == "self":
                return self.cls
            return self.types.get(node.id)
        if isinstance(node, ast.Attribute):
            base = self.type_of(node.value)
            if base is not None:
                return self.index.attr_type(base, node.attr)
            return None
        if isinstance(node, ast.Call):
            return self.index.resolve_class(self.mod,
                                            dotted_name(node.func))
        return None

    def is_tensor(self, node: ast.AST) -> bool:
        """Does this expression evaluate to a tensor?"""
        if isinstance(node, ast.Name):
            return node.id in self.names
        if isinstance(node, ast.Attribute):
            if node.attr in HOST_ATTRS:
                return False
            base = self.type_of(node.value)
            if base is not None and node.attr in self.index.fields(base):
                return True
            # t.T, t.mT, t.data, t.real of a tensor
            return node.attr in ("T", "mT", "data", "real", "imag") and \
                self.is_tensor(node.value)
        if isinstance(node, ast.Subscript):
            return self.is_tensor(node.value)
        if isinstance(node, ast.Starred):
            return self.is_tensor(node.value)
        if isinstance(node, ast.Call):
            name = dotted_name(node.func)
            if is_tensor_call_name(name):
                return True
            if isinstance(node.func, ast.Attribute):
                if node.func.attr in HOST_METHODS:
                    return False
                return self.is_tensor(node.func.value)
            return False
        if isinstance(node, ast.BinOp):
            return self.is_tensor(node.left) or self.is_tensor(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.is_tensor(node.operand)
        if isinstance(node, ast.Compare):
            # identity and membership tests are host operations
            if any(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops):
                return False
            return self.is_tensor(node.left) or any(
                self.is_tensor(c) for c in node.comparators)
        if isinstance(node, ast.BoolOp):
            return any(self.is_tensor(v) for v in node.values)
        if isinstance(node, ast.IfExp):
            return self.is_tensor(node.body) or self.is_tensor(node.orelse)
        return False
