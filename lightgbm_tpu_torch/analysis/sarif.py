"""Minimal SARIF 2.1.0 emitter shared by the AST and op-trace tiers of
torch-lint (a copy of ``lightgbm_tpu/analysis/sarif.py``, the same
document structure).

Emits one run with the findings as results; `level` maps severity
("error" -> error, "warn" -> warning). Trace-tier findings carry pseudo
URIs (``trace://entry@shape_class``) — SARIF viewers render them as
opaque locations, which is exactly right for a program-level contract.
"""
from __future__ import annotations

import json
from typing import Iterable, List

_LEVEL = {"error": "error", "warn": "warning"}


def render(findings: Iterable, tool_name: str, rules=None,
           errors: List[str] = ()) -> str:
    rule_meta = []
    seen = set()
    for r in rules or ():
        rid = getattr(r, "rule_id", None) or getattr(r, "id", None)
        if rid and rid not in seen:
            seen.add(rid)
            rule_meta.append({
                "id": rid,
                "shortDescription": {
                    "text": getattr(r, "summary", "")
                            or getattr(r, "title", "")},
            })
    results = []
    for f in findings:
        results.append({
            "ruleId": f.rule,
            "level": _LEVEL.get(getattr(f, "severity", "error"), "error"),
            "message": {"text": f.message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {"uri": f.path},
                    "region": {"startLine": max(1, f.line),
                               "startColumn": max(1, f.col)},
                },
            }],
            "partialFingerprints": {
                "torchLint/v1": f"{f.path}|{f.rule}|{f.snippet}",
            },
        })
    doc = {
        "$schema": ("https://raw.githubusercontent.com/oasis-tcs/"
                    "sarif-spec/master/Schemata/sarif-schema-2.1.0.json"),
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {"name": tool_name,
                                "informationUri":
                                    "README.md",
                                "rules": rule_meta}},
            "results": results,
            "invocations": [{
                "executionSuccessful": not errors,
                "toolExecutionNotifications": [
                    {"level": "error", "message": {"text": e}}
                    for e in errors],
            }],
        }],
    }
    return json.dumps(doc, indent=1)
