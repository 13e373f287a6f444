"""Trace-contract registry (the dependency-free half of the op-trace tier),
a copy of ``lightgbm_tpu/analysis/contracts/registry.py``.

Product modules register their entry points at import time with the
:func:`trace_entry` decorator — the registered object is the SHIPPED
callable (or class), so a contract always records the exact code the
booster runs, never a test-local copy. Contracts bind an entry to a
shape-class matrix and a list of predicate checks over the recorded
program (``op_trace.OpTrace``).

Everything here is importable without torch (the decorator rides inside
``grower.py`` / ``ops/`` / ``boosting/gbdt.py``); torch enters only when a
contract is *evaluated* (``trace_lint.py`` / the contract tests), through
the builders in ``entries.py``.

A target's ``expect`` field makes sensitivity first-class:

- ``"clean"``   — every check must pass (the shipped configuration);
- ``"violates"``— at least one check must FAIL (an arm kept as the
  sensitivity pin, e.g. a histogram pass without the grower's partition,
  whose positions a stable sort derives).
  If a violates-target starts passing, the contract has silently lost its
  teeth and lint reports *that* — tests and lint assert the same predicate
  through this one implementation.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

# entry id -> shipped callable/class, populated by product-module import
ENTRY_POINTS: Dict[str, Any] = {}

# (entry id, shape_class) -> builder() -> TracedProgram, populated by
# entries.py (and by --load'ed fixture files)
PROGRAM_BUILDERS: Dict[Tuple[str, str], Callable[[], "TracedProgram"]] = {}

# contract id -> Contract
CONTRACTS: Dict[str, "Contract"] = {}


def trace_entry(name: str):
    """Register the decorated object as traceable entry point ``name``.
    Returns the object unchanged — zero runtime cost in the product path."""
    def deco(obj):
        ENTRY_POINTS[name] = obj
        return obj
    return deco


def get_entry(name: str):
    if name not in ENTRY_POINTS:
        raise KeyError(
            f"trace entry {name!r} is not registered — its product module "
            f"was not imported or its @trace_entry hook was removed "
            f"(registered: {sorted(ENTRY_POINTS)})")
    return ENTRY_POINTS[name]


def program_builder(entry: str, shape_class: str):
    """Register a builder producing the traced program for one
    (entry, shape_class) cell of the matrix."""
    def deco(fn):
        PROGRAM_BUILDERS[(entry, shape_class)] = fn
        return fn
    return deco


@dataclass
class TracedProgram:
    """What a contract's checks see for one (entry, shape_class) cell."""
    entry: str
    shape_class: str
    trace: Any                      # op_trace.OpTrace of one call
    comm: Any = None                # collective_bytes() dict / 0-arg callable
    collectives: Any = None         # {kind: calls} counted at Collectives
    kernel_launches: Optional[int] = None   # B1 passes counted on the card
    expected_launches: Optional[int] = None
    notes: str = ""


@dataclass(frozen=True)
class Target:
    shape_class: str
    expect: str = "clean"           # "clean" | "violates"


@dataclass
class Contract:
    id: str                         # "T001"
    title: str
    entry: str                      # entry-point id
    checks: tuple                   # checks.py predicate objects
    targets: Tuple[Target, ...]
    severity: str = "error"         # "error" | "warn"
    doc: str = ""


def contract(id: str, title: str, entry: str, checks, targets,
             severity: str = "error", doc: str = "") -> Contract:
    """Define + register a contract. ``targets`` items may be shape-class
    strings (expect clean) or (shape_class, expect) pairs."""
    norm = tuple(t if isinstance(t, Target) else
                 (Target(*t) if isinstance(t, tuple) else Target(t))
                 for t in targets)
    c = Contract(id=id, title=title, entry=entry, checks=tuple(checks),
                 targets=norm, severity=severity, doc=doc)
    CONTRACTS[id] = c
    return c


# (entry, shape_class) -> TracedProgram, memoized across contracts that
# share a cell (recording is the expensive half of the tier)
_PROGRAM_CACHE: Dict[Tuple[str, str], TracedProgram] = {}


def build_program(entry: str, shape_class: str) -> TracedProgram:
    key = (entry, shape_class)
    if key not in _PROGRAM_CACHE:
        if key not in PROGRAM_BUILDERS:
            raise KeyError(
                f"no program builder for {entry!r} @ {shape_class!r} — "
                f"entries.py (or a --load'ed fixture) must register one "
                f"(known: {sorted(PROGRAM_BUILDERS)})")
        _PROGRAM_CACHE[key] = PROGRAM_BUILDERS[key]()
    return _PROGRAM_CACHE[key]


def evaluate_target(c: Contract, program: TracedProgram) -> List[str]:
    """Raw check failures for one traced program (empty = all pass)."""
    failures: List[str] = []
    for chk in c.checks:
        failures.extend(chk.run(program))
    return failures


def evaluate(c: Contract, t: Target, program: TracedProgram
             ) -> List[Tuple[str, str]]:
    """(fingerprint, message) findings for one (contract, target) cell,
    folding in the expect semantics: a clean target reports each check
    failure; a violates target reports only when NO check fails (lost
    sensitivity)."""
    failures = evaluate_target(c, program)
    cell = f"{c.entry}@{t.shape_class}"
    if t.expect == "violates":
        if not failures:
            return [(f"{c.id}:{cell}:sensitivity",
                     f"{c.title}: sensitivity lost — the "
                     f"{t.shape_class!r} pin no longer violates "
                     f"this contract, so the check proves nothing")]
        return []
    return [(f"{c.id}:{cell}:{msg.split(':', 1)[0]}",
             f"{c.title}: {msg}") for msg in failures]
