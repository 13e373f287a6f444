"""R004: a kernel binding that does not match its C interface.

The JAX package's R004 held Pallas block shapes to the TPU's tiling,
which its compiler checks only on the hardware. The port's kernels are
CUDA C++ with a plain C interface, loaded with ``ctypes`` (``ops/native.py``;
each wrapper binds its entries in its ``declare(lib)``), and there the
silent failure is the binding:
``lib.<fn>.argtypes = [...]`` that disagrees with the ``extern "C"``
signature in ``csrc/*.cu`` passes a pointer as a 32-bit int, or shifts
every argument after a missing one, and the kernel reads garbage with no
error (a ``long long`` read from an ``int`` slot, a cut pointer). Only a
run on the card would show it.

Checked statically: each ``<lib>.<fn>.argtypes`` (and ``.restype``)
assignment against the C function of that name in the ``csrc/`` directory
beside the module's package (the ``extern "C"`` blocks of its ``.cu``
files, every top-level function of its ``.c`` files, with their
``typedef``'d pointer handles): the count of arguments, and each one's kind —
pointer (``ctypes.c_void_p``, ``c_char_p``, ``POINTER``), ``int``
(``c_int``), ``long long`` (``c_longlong``, ``c_int64``, ``c_size_t``),
``double``, ``float``. Local aliases (``p, i = ctypes.c_void_p,
ctypes.c_int``) are followed. A binding to a name no C source defines is a
finding too.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Tuple

from .common import dotted_name

RULE_ID = "R004"

_CTYPES_KIND = {
    "c_void_p": "pointer", "c_char_p": "pointer", "c_wchar_p": "pointer",
    "POINTER": "pointer", "c_int": "int", "c_int32": "int",
    "c_uint": "int", "c_uint32": "int", "c_long": "long long",
    "c_longlong": "long long", "c_int64": "long long",
    "c_ulonglong": "long long", "c_uint64": "long long",
    "c_size_t": "long long", "c_ssize_t": "long long",
    "c_double": "double", "c_float": "float", "c_bool": "bool",
    "c_char": "char", "c_short": "short", "c_ushort": "short",
}
_C_KIND = {
    "int": "int", "int32_t": "int", "unsigned int": "int",
    "uint32_t": "int", "unsigned": "int", "long long": "long long",
    "unsigned long long": "long long", "int64_t": "long long",
    "uint64_t": "long long", "size_t": "long long", "long": "long long",
    "unsigned long": "long long", "ssize_t": "long long",
    "double": "double", "float": "float", "bool": "bool", "char": "char",
    "short": "short", "unsigned short": "short",
}
_DEF = re.compile(r"([A-Za-z_][\w\s\*]*?)\b([A-Za-z_]\w*)\s*\(([^;{}()]*)\)"
                  r"\s*\{")


def _strip_comments(src: str) -> str:
    src = re.sub(r"/\*.*?\*/", " ", src, flags=re.S)
    return re.sub(r"//[^\n]*", " ", src)


def _extern_c_blocks(src: str) -> List[str]:
    """The bodies of every ``extern "C" { ... }`` block."""
    out = []
    for m in re.finditer(r'extern\s+"C"\s*\{', src):
        depth, i = 1, m.end()
        while i < len(src) and depth:
            depth += {"{": 1, "}": -1}.get(src[i], 0)
            i += 1
        out.append(src[m.end():i - 1])
    return out


def _top_level(src: str) -> str:
    """``src`` with every brace-enclosed body blanked, so that only
    top-level definitions' headers remain (each followed by ``{}``)."""
    out, depth = [], 0
    for ch in src:
        if ch == "{":
            if depth == 0:
                out.append("{")
            depth += 1
        elif ch == "}":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out)


def _kind_of_c(decl: str, pointers=frozenset()) -> str:
    decl = decl.strip()
    if "*" in decl:
        return "pointer"
    # qualifiers, storage classes and export macros (upper-case words)
    words = [w for w in decl.split()
             if w not in ("const", "volatile", "struct", "extern", "static",
                          "inline") and not w.isupper()]
    if words and words[0] in pointers:
        return "pointer"
    if len(words) > 1 and " ".join(words[:-1]) in _C_KIND:
        words = words[:-1]                       # drop the parameter name
    return _C_KIND.get(" ".join(words), " ".join(words))


def c_signatures(csrc: str) -> Dict[str, Tuple[str, List[str], str]]:
    """``{name: (return kind, [argument kinds], file)}`` of the C-linkage
    functions defined in ``csrc``: the ``extern "C"`` blocks of its ``.cu``
    files, the top level of its ``.c`` files."""
    out: Dict[str, Tuple[str, List[str], str]] = {}
    for fname in sorted(os.listdir(csrc)):
        if not fname.endswith((".cu", ".c")):
            continue
        with open(os.path.join(csrc, fname), encoding="utf-8") as fh:
            src = _strip_comments(fh.read())
        src = re.sub(r"^\s*#[^\n]*", " ", src, flags=re.M)
        pointers = set(re.findall(r"typedef\s+[\w\s]*\*\s*(\w+)\s*;", src))
        blocks = _extern_c_blocks(src) if fname.endswith(".cu") else [src]
        for block in blocks:
            for m in _DEF.finditer(_top_level(block)):
                ret, name, params = m.group(1), m.group(2), m.group(3)
                if name in ("if", "for", "while", "switch", "return"):
                    continue
                args = [p for p in params.split(",") if p.strip()]
                if len(args) == 1 and args[0].strip() == "void":
                    args = []
                out[name] = (_kind_of_c(ret, pointers),
                             [_kind_of_c(a, pointers) for a in args], fname)
    return out


def find_csrc(path: str) -> Optional[str]:
    """The ``csrc/`` directory of the package ``path`` lives in: the
    nearest ancestor directory holding one."""
    d = os.path.dirname(os.path.abspath(path))
    for _ in range(4):
        cand = os.path.join(d, "csrc")
        if os.path.isdir(cand):
            return cand
        d = os.path.dirname(d)
    return None


def _aliases(tree: ast.AST) -> Dict[str, str]:
    """Local names bound to ctypes types: ``p = ctypes.c_void_p`` and
    ``p, i = ctypes.c_void_p, ctypes.c_int``."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        t, v = node.targets[0], node.value
        pairs = []
        if isinstance(t, ast.Name):
            pairs = [(t, v)]
        elif isinstance(t, ast.Tuple) and isinstance(v, ast.Tuple) \
                and len(t.elts) == len(v.elts):
            pairs = list(zip(t.elts, v.elts))
        for tn, vn in pairs:
            name = dotted_name(vn) or ""
            leaf = name.rsplit(".", 1)[-1]
            if isinstance(tn, ast.Name) and leaf in _CTYPES_KIND:
                out[tn.id] = leaf
    return out


def _ctype_kind(node: ast.AST, aliases: Dict[str, str]) -> str:
    if isinstance(node, ast.Call):           # ctypes.POINTER(ctypes.c_int)
        node = node.func
    name = dotted_name(node) or "<expr>"
    leaf = aliases.get(name, name.rsplit(".", 1)[-1])
    return _CTYPES_KIND.get(leaf, leaf)


class KernelBindingRule:
    rule_id = RULE_ID
    summary = ("ctypes argtypes/restype of a kernel binding that disagree "
               "with its extern \"C\" signature in csrc/ (count or "
               "pointer/int/long long kinds) — a silent corruption")

    def check(self, ctx):
        sites = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Attribute) \
                    and node.targets[0].attr in ("argtypes", "restype"):
                fn = node.targets[0].value
                if isinstance(fn, ast.Attribute):
                    sites.append((node, fn.attr, node.targets[0].attr))
        if not sites:
            return
        csrc = find_csrc(ctx.path)
        sigs = c_signatures(csrc) if csrc else {}
        aliases = _aliases(ctx.tree)
        for node, fname, what in sites:
            sig = sigs.get(fname)
            if sig is None:
                yield ctx.finding(
                    self.rule_id, node,
                    f"`{fname}` is bound with ctypes but no C function of "
                    f"that name is defined in "
                    f"{'csrc/' if csrc else 'a csrc/ directory'}")
                continue
            ret, args, src = sig
            if what == "restype":
                got = _ctype_kind(node.value, aliases)
                if ret != "void" and got != ret:
                    yield ctx.finding(
                        self.rule_id, node,
                        f"`{fname}.restype` is {got}, but csrc/{src} "
                        f"returns {ret}")
                continue
            if not isinstance(node.value, (ast.List, ast.Tuple)):
                continue
            got = [_ctype_kind(e, aliases) for e in node.value.elts]
            if len(got) != len(args):
                yield ctx.finding(
                    self.rule_id, node,
                    f"`{fname}.argtypes` has {len(got)} entries, but the C "
                    f"function in csrc/{src} takes {len(args)} — every "
                    f"argument after the first difference is read from the "
                    f"wrong slot")
                continue
            for i, (g, c) in enumerate(zip(got, args)):
                if g != c:
                    yield ctx.finding(
                        self.rule_id, node,
                        f"`{fname}.argtypes[{i}]` is {g}, but argument "
                        f"{i} of the C function in csrc/{src} is {c} — "
                        f"ctypes converts it silently")
                    break
