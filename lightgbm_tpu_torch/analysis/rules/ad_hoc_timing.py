"""R008: ad-hoc wall-clock timing inside the port.

As the JAX package's R008
(``lightgbm_tpu/analysis/rules/ad_hoc_timing.py``): ``time.time()`` /
``time.perf_counter()`` sprinkled through ``lightgbm_tpu_torch/``
produce numbers nobody can find again: they print once
(or feed a local variable) and never reach the metrics registry, the
span trace, or the BENCH json. The observability subsystem exists so
every timing lands in ONE place — use ``observability.span(...)`` for
wall-clock sections, ``PhaseBreakdown`` for compile/steady attribution,
or a registry gauge for one-off durations. Worse, a naive ``perf_counter``
pair around a CUDA launch measures the *enqueue*, not device time
(execution is asynchronous) — the exact confusion the span docs call out.

Scope: files under ``lightgbm_tpu_torch/`` EXCEPT ``observability/`` and
``utils/timer.py`` (the TIMETAG accumulator), the homes of the primitive.
Audited sites elsewhere belong in ``torch_lint_baseline.json``; any NEW
ad-hoc timer fails the lint.

Both the dotted form (``time.perf_counter()``) and names imported via
``from time import perf_counter`` are caught; ``time.monotonic`` deadline
arithmetic (retry/chaos budgets) is not timing instrumentation and stays
out of scope.
"""
from __future__ import annotations

import ast

from .common import dotted_name, in_package

RULE_ID = "R008"

_TIMING_DOTTED = {"time.time", "time.perf_counter", "time.perf_counter_ns"}
_TIMING_FROM = {"time", "perf_counter", "perf_counter_ns"}

_EXEMPT_MARKERS = ("lightgbm_tpu_torch/observability/",
                   "lightgbm_tpu_torch/utils/timer.py")


def _in_scope(rel: str) -> bool:
    rel = rel.replace("\\", "/")
    if not in_package(rel):
        return False
    return not any(m in rel for m in _EXEMPT_MARKERS)


def _from_time_aliases(tree) -> set:
    """Local names bound by ``from time import time/perf_counter[ as x]``."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == "time":
            for alias in node.names:
                if alias.name in _TIMING_FROM:
                    out.add(alias.asname or alias.name)
    return out


class AdHocTimingRule:
    rule_id = RULE_ID
    summary = ("ad-hoc time.time()/time.perf_counter() timing in "
               "lightgbm_tpu_torch/ outside observability/ and "
               "utils/timer.py (use spans / PhaseBreakdown so the number "
               "lands in the registry/trace)")

    def check(self, ctx):
        if not _in_scope(ctx.rel):
            return
        aliases = _from_time_aliases(ctx.tree)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func) or ""
            if name in _TIMING_DOTTED or (name in aliases and "." not in name):
                yield ctx.finding(
                    self.rule_id, node,
                    f"`{name}()` is ad-hoc wall-clock timing — route it "
                    f"through observability (span()/PhaseBreakdown/a "
                    f"registry gauge) so the measurement is findable in "
                    f"the trace and snapshot; audited sites belong "
                    f"in torch_lint_baseline.json")
