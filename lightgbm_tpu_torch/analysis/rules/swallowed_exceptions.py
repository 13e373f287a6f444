"""R010: swallowed broad exceptions in the port.

As the JAX package's R010
(``lightgbm_tpu/analysis/rules/swallowed_exceptions.py``), over
``lightgbm_tpu_torch/``.

``except Exception: pass`` (and the bare-``except``-and-``continue``
variants) silently eats EVERY failure class — including the faults the
self-healing layer (``robustness/``) exists to detect: a checkpoint that failed verification, a shard CRC mismatch, a
comm timeout. A fault that is swallowed instead of raised/logged never
reaches the lineage fallback, the watchdog, or the supervisor — the run
keeps going on corrupt state, which is strictly worse than dying.

Flagged: an ``except`` handler that is BROAD (bare ``except:``,
``except Exception``, ``except BaseException``, or a tuple containing one
of those) whose body does NOTHING but ``pass``/``continue``. Narrow
handlers (``except OSError: pass`` around a best-effort unlink) express a
deliberate, bounded decision and stay out of scope, as does any broad
handler that logs, re-raises, counts, or returns a fallback — the rule
targets the silent black hole only.

Intentional sites — best-effort cleanup where even logging can fail —
belong in ``torch_lint_baseline.json``, recording the audit; any NEW silent
broad catch fails the lint.
"""
from __future__ import annotations

import ast

from .common import in_package

RULE_ID = "R010"

_BROAD = {"Exception", "BaseException"}


def _is_broad(handler_type) -> bool:
    """bare except, Exception/BaseException (dotted or not), or a tuple
    containing one of those."""
    if handler_type is None:
        return True
    if isinstance(handler_type, ast.Tuple):
        return any(_is_broad(el) for el in handler_type.elts)
    if isinstance(handler_type, ast.Name):
        return handler_type.id in _BROAD
    if isinstance(handler_type, ast.Attribute):
        return handler_type.attr in _BROAD
    return False


def _only_passes(body) -> bool:
    return all(isinstance(stmt, (ast.Pass, ast.Continue)) for stmt in body)


class SwallowedExceptionRule:
    rule_id = RULE_ID
    summary = ("broad exception handler that only passes/continues "
               "(`except Exception: pass`, bare except) — swallowed faults "
               "defeat the self-healing layer; log, count, or narrow the "
               "exception type instead")

    def check(self, ctx):
        if not in_package(ctx.rel):
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if _is_broad(node.type) and _only_passes(node.body):
                what = ("bare `except:`" if node.type is None
                        else f"`except {ast.unparse(node.type)}`")
                yield ctx.finding(
                    self.rule_id, node,
                    f"{what} with a body that only "
                    f"passes/continues swallows every failure class — "
                    f"faults the robustness layer needs to see "
                    f"(checkpoint corruption, shard CRC mismatches, comm "
                    f"timeouts) die here silently; log it, count it "
                    f"(observability.inc), narrow the type, or baseline "
                    f"the audited site in torch_lint_baseline.json")
