"""R012: worker threads created without a leak-proof lifecycle.

As the JAX package's R012 (``lightgbm_tpu/analysis/rules/thread_leak.py``),
over ``lightgbm_tpu_torch/``: the port runs real worker threads (the
shard prefetcher, the hang watchdog, the ingest feeder, the micro-batcher
worker, the circuit-breaker probe, the chaos killer). A
``threading.Thread`` that is neither ``daemon=True`` nor ``join()``-ed
from a reachable cleanup method outlives its owner: a test leaks it, a
closed server keeps a runner pinned to a dead queue, and interpreter
shutdown blocks on it — exactly the "enqueue into a dead worker and hang
the caller" class the typed serving shutdown exists to prevent.

What fires, for ``threading.Thread(...)`` / ``Thread(...)`` construction
inside ``lightgbm_tpu_torch/``:

- the constructor has no ``daemon=True`` keyword, AND
- no reachable ``join()`` is found for the created thread:
  - ``self.x = Thread(...)`` is cleared by ``self.x.join(...)`` inside a
    cleanup method of the same class (``close`` / ``stop`` / ``shutdown``
    / ``__exit__`` / ``__del__`` / ``join``), or by a cleanup method
    handing ``self.x`` to a helper — same file or across an import, via
    the whole-package call graph — that join()s the parameter;
  - ``t = Thread(...)`` (local) is cleared by ``t.join(...)`` anywhere in
    the same function (the loadgen pattern: start workers, join them);
  - an unassigned ``Thread(...).start()`` has nothing to join and always
    needs ``daemon=True``.

Either discipline is fine — daemon threads die with the process, joined
threads die with their owner. A thread with neither is a leak waiting
for a wedge; fix it or baseline an audited site.
"""
from __future__ import annotations

import ast
from typing import Optional, Set

from .common import dotted_name, in_package

RULE_ID = "R012"

_THREAD_CTORS = {"threading.Thread", "Thread"}
_CLEANUP_METHODS = {"close", "stop", "shutdown", "join", "__exit__",
                    "__del__"}


def _is_daemon_true(call: ast.Call) -> bool:
    for kw in call.keywords:
        if kw.arg == "daemon" and isinstance(kw.value, ast.Constant) \
                and kw.value.value is True:
            return True
    return False


def _self_attr(node: ast.AST) -> Optional[str]:
    """'x' for a ``self.x`` attribute node, else None."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _joined_self_attrs(cls: ast.ClassDef) -> Set[str]:
    """Attrs ``x`` with ``self.x.join(...)`` inside a cleanup method."""
    out: Set[str] = set()
    for item in cls.body:
        if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if item.name not in _CLEANUP_METHODS:
            continue
        for node in ast.walk(item):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "join":
                attr = _self_attr(node.func.value)
                if attr:
                    out.add(attr)
    return out


def _raw_params(fn: ast.FunctionDef):
    a = fn.args
    return [p.arg for p in a.posonlyargs + a.args]


def _delegated_join_attrs(ctx, cls: ast.ClassDef) -> Set[str]:
    """Attrs ``x`` whose cleanup method hands ``self.x`` to a helper that
    join()s the corresponding parameter — ``close()`` calling
    ``drain_worker(self._thread)`` where ``drain_worker`` (same file or
    across an import, via the package call graph) does ``t.join()``."""
    index = getattr(ctx, "package", None)
    if index is None:
        return set()
    mod = index.by_path.get(ctx.rel)
    if mod is None:
        return set()
    out: Set[str] = set()
    for item in cls.body:
        if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if item.name not in _CLEANUP_METHODS:
            continue
        for node in ast.walk(item):
            if not isinstance(node, ast.Call):
                continue
            callee = dotted_name(node.func)
            if not callee or callee.startswith("self."):
                continue
            passed = [(i, _self_attr(a)) for i, a in enumerate(node.args)
                      if _self_attr(a)]
            if not passed:
                continue
            for _, helper in index.resolve(mod, callee):
                params = _raw_params(helper)
                joined = _joined_locals(helper)
                for i, attr in passed:
                    if i < len(params) and params[i] in joined:
                        out.add(attr)
    return out


def _joined_locals(fn: ast.FunctionDef) -> Set[str]:
    """Local names ``t`` with ``t.join(...)`` anywhere in ``fn``."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == "join" and \
                isinstance(node.func.value, ast.Name):
            out.add(node.func.value.id)
    return out


def _contains_thread_ctor(node: ast.AST) -> bool:
    return any(isinstance(n, ast.Call) and
               (dotted_name(n.func) or "") in _THREAD_CTORS
               for n in ast.walk(node))


def _thread_bound_names(fn: ast.FunctionDef) -> Set[str]:
    """Local names that (transitively) hold Thread objects: assigned from
    an expression containing a Thread ctor (``t = Thread(...)``,
    ``ts = [Thread(...) for ...]``), appended into
    (``ts.append(Thread(...))``), or a loop variable over such a name
    (``for t in ts:``) — so a bare ``sep.join(parts)`` on a string never
    counts as joining a worker."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and _contains_thread_ctor(node.value):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    out.add(tgt.id)
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == "append" and \
                isinstance(node.func.value, ast.Name) and \
                any(_contains_thread_ctor(a) for a in node.args):
            out.add(node.func.value.id)
    changed = True
    while changed:                       # for t in ts / for t in (ts + us)
        changed = False
        for node in ast.walk(fn):
            if isinstance(node, (ast.For, ast.AsyncFor)) and \
                    isinstance(node.target, ast.Name) and \
                    node.target.id not in out and \
                    any(isinstance(n, ast.Name) and n.id in out
                        for n in ast.walk(node.iter)):
                out.add(node.target.id)
                changed = True
    return out


class ThreadLeakRule:
    rule_id = RULE_ID
    cross_module = True   # join delegation resolves through the call graph
    summary = ("threading.Thread created without daemon=True or a "
               "reachable join() in a close()/__exit__-style cleanup — "
               "the worker outlives its owner (leak / shutdown hang)")

    def check(self, ctx):
        if not in_package(ctx.rel):
            return
        yield from self._walk(ctx, ctx.tree, cls=None, fn=None)

    def _walk(self, ctx, node, cls, fn):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                yield from self._walk(ctx, child, cls=child, fn=fn)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from self._walk(ctx, child, cls=cls, fn=child)
            else:
                for call in ast.walk(child):
                    if isinstance(call, ast.Call) and \
                            (dotted_name(call.func) or "") in _THREAD_CTORS:
                        f = self._judge(ctx, call, child, cls, fn)
                        if f is not None:
                            yield f

    def _judge(self, ctx, call: ast.Call, stmt: ast.AST,
               cls: Optional[ast.ClassDef], fn) -> Optional[object]:
        if _is_daemon_true(call):
            return None
        # where does the thread land? self.<attr>, a local name, a
        # container (comprehension/list literal), or nowhere. The binding
        # Assign may sit anywhere inside the statement (if/try/with), so
        # find the one whose value IS this call rather than requiring a
        # top-level assignment
        targets = []
        for n in ast.walk(stmt):
            if isinstance(n, ast.Assign) and n.value is call:
                targets = n.targets
                break
            if isinstance(n, ast.AnnAssign) and n.value is call:
                targets = [n.target]
                break
        target_attr = target_name = None
        for tgt in targets:
            a = _self_attr(tgt)
            if a:
                target_attr = a
            elif isinstance(tgt, ast.Name):
                target_name = tgt.id
        if target_attr and cls is not None and \
                (target_attr in _joined_self_attrs(cls)
                 or target_attr in _delegated_join_attrs(ctx, cls)):
            return None
        if target_name and fn is not None and \
                target_name in _joined_locals(fn):
            return None
        # container / fire-and-forget pattern: threads collected then
        # joined in the same function ([Thread(...) for ...] with a later
        # `for t in ts: t.join()` loop) — the thread object itself is not
        # name-trackable, so accept a join() on a name that actually
        # holds threads (never, e.g., a str.join on a local)
        if not targets and fn is not None and \
                _joined_locals(fn) & _thread_bound_names(fn):
            return None
        return ctx.finding(
            self.rule_id, call,
            "worker thread is neither daemon=True nor join()-ed from a "
            "cleanup method (close/stop/shutdown/__exit__) — it outlives "
            "its owner and leaks (or wedges interpreter shutdown); mark it "
            "daemon or join it in close()")
