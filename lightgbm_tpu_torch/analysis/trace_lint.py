"""Op-trace tier of torch-lint: contracts over recorded aten operations.

``python -m lightgbm_tpu_torch.analysis --trace`` records, for every
(entry, shape_class) cell a contract targets, one call of the SHIPPED
callable registered by the product modules' ``@trace_entry`` hooks
(``contracts/entries.py``, on the CPU at small shapes), and evaluates the
declarative predicates in ``contracts/checks.py``: forbidden operations
(with a minimum input size), collectives against ``collective_bytes()``,
dtype discipline against the f64 allowlist, host transfers in a recorded
region, operation and kernel-pass counts.

Findings use pseudo-paths ``trace://<entry>@<shape_class>`` and the check
kind token as the snippet, so the AST tier's baseline machinery
(fingerprints, ``--update-baseline``, stale-entry detection) applies
unchanged; the trace baseline lives in ``torch_trace_baseline.json``. A
``violates`` target that starts passing is reported ("sensitivity
lost"), as in the JAX tier (``lightgbm_tpu/analysis/trace_lint.py``).

Unlike the AST tier this imports torch; it runs on the CPU with one
intra-op thread.
"""
from __future__ import annotations

import json
import os
import runpy
import sys
from dataclasses import asdict
from typing import List

TRACE_BASELINE = "torch_trace_baseline.json"


def _load_fixture(path: str) -> None:
    """Exec a contract-registration file (tests plant violating contracts
    and program builders through these)."""
    runpy.run_path(path, run_name=f"torch_lint_fixture:{path}")


def run_trace(args) -> int:
    import torch
    torch.set_num_threads(1)

    from . import contracts as reg
    from .contracts import entries  # noqa: F401  (registers the contracts)
    from .tpu_lint import Baseline, Finding, stale_baseline_entries

    for fixture in args.load:
        _load_fixture(fixture)

    contract_ids = sorted(reg.CONTRACTS)
    if args.list_rules:
        for cid in contract_ids:
            print(f"{cid}  {reg.CONTRACTS[cid].title}")
        return 0
    if args.select:
        wanted = {s.strip().upper() for s in args.select.split(",")}
        unknown = wanted - set(contract_ids)
        if unknown:
            print(f"unknown contract id(s): {', '.join(sorted(unknown))}",
                  file=sys.stderr)
            return 2
        contract_ids = [c for c in contract_ids if c in wanted]

    findings: List[Finding] = []
    errors: List[str] = []
    evaluated = set()
    for cid in contract_ids:
        c = reg.CONTRACTS[cid]
        for t in c.targets:
            cell = f"trace://{c.entry}@{t.shape_class}"
            try:
                program = reg.build_program(c.entry, t.shape_class)
            except Exception as e:                    # builder failure
                errors.append(f"{cell}: cannot build program for {cid}: "
                              f"{type(e).__name__}: {e}")
                continue
            evaluated.add(cell)
            for fingerprint, message in reg.evaluate(c, t, program):
                findings.append(Finding(
                    rule=cid, path=cell, line=1, col=1, message=message,
                    snippet=fingerprint, severity=c.severity))
    findings.sort(key=lambda f: (f.rule, f.path, f.snippet))

    write_baseline = args.write_baseline
    if args.update_baseline:
        write_baseline = args.baseline or TRACE_BASELINE
    if write_baseline:
        fresh = Baseline.from_findings(findings)
        if os.path.exists(write_baseline):
            try:                        # keep the audited entries' reasons
                fresh.reasons = Baseline.load(write_baseline).reasons
            except (OSError, ValueError, KeyError):
                pass
        fresh.dump(write_baseline)
        print(f"torch-lint --trace: wrote {len(findings)} finding(s) to "
              f"{write_baseline}")
        return 0

    baseline_path = None
    if not args.no_baseline:
        baseline_path = args.baseline or (
            TRACE_BASELINE if os.path.exists(TRACE_BASELINE) else None)
    stale = []
    if baseline_path:
        try:
            baseline = Baseline.load(baseline_path)
        except (OSError, ValueError, KeyError) as e:
            print(f"torch-lint: cannot load baseline {baseline_path}: {e}",
                  file=sys.stderr)
            return 2
        findings = [f for f in findings if not baseline.suppresses(f)]
        stale = stale_baseline_entries(baseline, evaluated)

    gating = [f for f in findings if f.severity == "error"]
    if args.format == "json":
        print(json.dumps(
            {"findings": [asdict(f) for f in findings],
             "errors": errors,
             "stale_baseline": [
                 {"file": k[0], "rule": k[1], "snippet": k[2], "count": n}
                 for k, n in stale]}, indent=1))
    elif args.format == "sarif":
        from .sarif import render
        rules = [reg.CONTRACTS[c] for c in sorted(reg.CONTRACTS)]
        print(render(findings, "torch-lint-trace", rules=rules,
                     errors=errors))
    else:
        for f in findings:
            print(f.format())
        for (cell, cid, snippet), n in stale:
            print(f"{cell}: stale baseline entry for {cid} (x{n}) no "
                  f"longer matches any finding: {snippet!r} — remove it "
                  f"or run --trace --update-baseline")
        suffix = f" (baseline: {baseline_path})" if baseline_path else ""
        print(f"torch-lint --trace: {len(reg.CONTRACTS)} contract(s), "
              f"{len(evaluated)} cell(s), {len(findings)} finding(s)"
              f"{suffix}"
              + (f", {len(stale)} stale baseline entrie(s)" if stale else ""))
    for err in errors:
        print(f"torch-lint: {err}", file=sys.stderr)
    if errors:
        return 2
    return 1 if gating or stale else 0
