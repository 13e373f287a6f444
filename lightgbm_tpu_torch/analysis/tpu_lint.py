"""torch-lint: AST hygiene analyzer for the PyTorch/CUDA port (rules
R001-R013).

The port of ``lightgbm_tpu/analysis/tpu_lint.py``: the same engine —
findings, inline and file pragmas, a committed baseline of fingerprints,
stale-entry detection, a whole-package call graph and exit codes — over
rules that carry the JAX package's hazards into PyTorch's terms: a host
sync (``.item()``, ``.tolist()``, ``.cpu()``, ``int(t)``) on the per-wave
path, a Python branch on a device tensor inside a part a CUDA graph
captures, a tensor rebound where the graphs read a fixed address, a ctypes
binding that disagrees with its kernel's C interface (``rules/``).

Deliberately dependency-free: stdlib ``ast`` only, no torch import, so the
linter runs anywhere in milliseconds.

Suppression:
- inline, same line:   ``x = float(s)  # torch-lint: disable=R002``
- whole file:          ``# torch-lint: disable-file=R006`` on any line
- baseline file:       committed ``torch_lint_baseline.json`` holding
  fingerprints (file, rule, stripped source line) of audited findings;
  regenerate with ``--update-baseline`` after an audited change.
- ``@allowed_host_sync("<reason>")`` (``lightgbm_tpu_torch.robustness``)
  on a function marks an audited sync point for R002 and R011.

Exit codes: 0 clean (after suppressions), 1 findings or stale baseline
entries, 2 usage/parse error.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys
from collections import Counter
from dataclasses import asdict, dataclass
from typing import Iterable, List, Optional, Tuple

DEFAULT_BASELINE = "torch_lint_baseline.json"

_PRAGMA = re.compile(r"#\s*torch-lint:\s*disable=([A-Za-z0-9_,\s]+)")
_PRAGMA_FILE = re.compile(r"#\s*torch-lint:\s*disable-file=([A-Za-z0-9_,\s]+)")


@dataclass
class Finding:
    rule: str
    path: str          # repo-relative, "/" separators
    line: int          # 1-based
    col: int
    message: str
    snippet: str       # stripped source line (baseline fingerprint)
    severity: str = "error"   # "error" gates exit code; "warn" reports only

    def format(self) -> str:
        tag = "" if self.severity == "error" else f" [{self.severity}]"
        return (f"{self.path}:{self.line}:{self.col}: {self.rule}{tag} "
                f"{self.message}\n    {self.snippet}")


class FileContext:
    """One parsed source file handed to every rule."""

    def __init__(self, path: str, rel: str, source: str):
        self.path = path
        self.rel = rel.replace(os.sep, "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree = None  # ast.Module, set by lint_file
        self.package = None  # rules.common.PackageIndex, set by lint_paths

    def snippet(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""

    def finding(self, rule: str, node, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0) + 1
        return Finding(rule=rule, path=self.rel, line=line, col=col,
                       message=message, snippet=self.snippet(line))


# ---------------------------------------------------------------- suppression

def _inline_disabled(ctx: FileContext, f: Finding) -> bool:
    if not (1 <= f.line <= len(ctx.lines)):
        return False
    m = _PRAGMA.search(ctx.lines[f.line - 1])
    if not m:
        return False
    ids = {s.strip().upper() for s in m.group(1).split(",")}
    return "ALL" in ids or f.rule in ids


def _file_disabled_rules(ctx: FileContext) -> set:
    out = set()
    for line in ctx.lines:
        m = _PRAGMA_FILE.search(line)
        if m:
            out |= {s.strip().upper() for s in m.group(1).split(",")}
    return out


class Baseline:
    """Committed fingerprints of audited pre-existing findings.

    A finding is suppressed when an unconsumed (file, rule, snippet) entry
    matches — line numbers are deliberately NOT part of the fingerprint so
    unrelated edits above a finding don't invalidate the baseline."""

    def __init__(self, entries: Counter = None, reasons: dict = None):
        self.entries = Counter(entries or ())
        self._unused = Counter(self.entries)
        # why each entry is audited (kept across --update-baseline)
        self.reasons = dict(reasons or {})

    @classmethod
    def load(cls, path: str) -> "Baseline":
        with open(path) as fh:
            data = json.load(fh)
        c, reasons = Counter(), {}
        for e in data.get("findings", []):
            key = (e["file"], e["rule"], e["snippet"])
            c[key] += int(e.get("count", 1))
            if e.get("reason"):
                reasons[key] = e["reason"]
        return cls(c, reasons)

    @classmethod
    def from_findings(cls, findings: Iterable[Finding]) -> "Baseline":
        c = Counter((f.path, f.rule, f.snippet) for f in findings)
        return cls(c)

    def suppresses(self, f: Finding) -> bool:
        key = (f.path, f.rule, f.snippet)
        if self._unused.get(key, 0) > 0:
            self._unused[key] -= 1
            return True
        return False

    def dump(self, path: str) -> None:
        findings = [dict({"file": k[0], "rule": k[1], "snippet": k[2],
                          "count": n},
                         **({"reason": self.reasons[k]}
                            if k in self.reasons else {}))
                    for k, n in sorted(self.entries.items())]
        with open(path, "w") as fh:
            json.dump({"version": 1, "findings": findings}, fh, indent=1)
            fh.write("\n")


# ------------------------------------------------------------------- running

def _iter_py_files(paths: Iterable[str]) -> Iterable[str]:
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
        else:
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", ".git",
                                              "build"))
                for name in sorted(files):
                    if name.endswith(".py"):
                        yield os.path.join(root, name)


def _parse_source(path: str, rel: str, source: str) -> FileContext:
    import ast
    ctx = FileContext(path, rel, source)
    ctx.tree = ast.parse(source, filename=path)
    return ctx


def _check_ctx(ctx: FileContext, rules) -> List[Finding]:
    """Run ``rules`` over one parsed file, applying pragma suppression."""
    file_off = _file_disabled_rules(ctx)
    findings = []
    for rule in rules:
        if rule.rule_id in file_off or "ALL" in file_off:
            continue
        for f in rule.check(ctx):
            if not _inline_disabled(ctx, f):
                findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def lint_file(path: str, rel: str = None, rules=None
              ) -> Tuple[List[Finding], Optional[str]]:
    """Lint one file standalone (same-file reachability semantics).
    Returns (findings, parse_error)."""
    from .rules import active_rules

    rules = rules if rules is not None else active_rules()
    rel = rel if rel is not None else os.path.relpath(path)
    try:
        with open(path, "r", encoding="utf-8") as fh:
            source = fh.read()
        ctx = _parse_source(path, rel, source)
    except (OSError, SyntaxError, ValueError) as e:
        return [], f"{rel}: cannot parse: {e}"
    return _check_ctx(ctx, rules), None


def lint_paths(paths: Iterable[str], rules=None, cache=None
               ) -> Tuple[List[Finding], List[str]]:
    """Lint a file set as one package: every file is parsed first, a
    whole-package call graph (``rules.common.PackageIndex``) is built and
    attached as ``ctx.package``, then rules run — so R007/R009/R012 see
    cross-module reachability. ``cache`` (a ``lint_cache.LintCache``) skips
    re-parsing when content hashes are unchanged."""
    from .rules import active_rules
    from .rules.common import PackageIndex

    rules = rules if rules is not None else active_rules()
    sources, errors = [], []
    for path in _iter_py_files(paths):
        rel = os.path.relpath(path).replace(os.sep, "/")
        try:
            with open(path, "r", encoding="utf-8") as fh:
                sources.append((path, rel, fh.read()))
        except OSError as e:
            errors.append(f"{rel}: cannot parse: {e}")

    if cache is not None and not errors:
        hit = cache.replay(sources, [r.rule_id for r in rules])
        if hit is not None:
            return hit, errors

    ctxs = []
    for path, rel, source in sources:
        try:
            ctxs.append(_parse_source(path, rel, source))
        except (SyntaxError, ValueError) as e:
            errors.append(f"{rel}: cannot parse: {e}")

    index = PackageIndex.build([(c.path, c.rel, c.tree) for c in ctxs])
    local_rules = [r for r in rules
                   if not getattr(r, "cross_module", False)]
    cross_rules = [r for r in rules if getattr(r, "cross_module", False)]

    findings: List[Finding] = []
    per_file = {}
    for ctx in ctxs:
        ctx.package = index
        if cache is not None:
            cached_local = cache.cached_local(
                ctx.rel, ctx.source, [r.rule_id for r in rules])
            local = cached_local if cached_local is not None \
                else _check_ctx(ctx, local_rules)
        else:
            local = _check_ctx(ctx, local_rules)
        cross = _check_ctx(ctx, cross_rules)
        per_file[ctx.rel] = (ctx.source, local, cross)
        findings.extend(local)
        findings.extend(cross)

    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    if cache is not None and not errors:
        cache.store(sources, [r.rule_id for r in rules], per_file)
    return findings, errors


# ----------------------------------------------------------------------- CLI

def _resolve_baseline(arg: Optional[str], no_baseline: bool) -> Optional[str]:
    if no_baseline:
        return None
    if arg:
        return arg
    return DEFAULT_BASELINE if os.path.exists(DEFAULT_BASELINE) else None


def stale_baseline_entries(baseline: "Baseline",
                           linted_rels) -> List[Tuple[tuple, int]]:
    """Baseline entries that matched nothing this run and whose file was
    either linted (so the finding demonstrably no longer exists) or is gone
    from disk. Entries for files outside a subset-path run are left alone —
    a `torch-lint some/dir` invocation can't prove anything about the rest of
    the tree."""
    linted = set(linted_rels)
    stale = []
    for key, remaining in sorted(baseline._unused.items()):
        if remaining <= 0:
            continue
        rel = key[0]
        if rel in linted or not os.path.exists(rel):
            stale.append((key, remaining))
    return stale


def main(argv: Optional[List[str]] = None) -> int:
    from .rules import active_rules

    ap = argparse.ArgumentParser(
        prog="python -m lightgbm_tpu_torch.analysis",
        description="torch-lint: PyTorch/CUDA hygiene analyzer — AST tier "
                    "(rules R001-R013) and op-trace tier (--trace: "
                    "contracts over recorded aten operations)")
    ap.add_argument("paths", nargs="*", default=["lightgbm_tpu_torch"],
                    help="files or directories to lint")
    ap.add_argument("--trace", action="store_true",
                    help="run the op-trace contract tier (aten operations "
                         "recorded on the CPU) instead of the AST tier")
    ap.add_argument("--baseline", default=None, metavar="FILE",
                    help=f"suppressions baseline (default: {DEFAULT_BASELINE} "
                         "in the current directory, when present; the trace "
                         "tier defaults to torch_trace_baseline.json)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore any baseline file")
    ap.add_argument("--write-baseline", nargs="?", const=DEFAULT_BASELINE,
                    default=None, metavar="FILE",
                    help="write current findings as the new baseline and exit 0")
    ap.add_argument("--update-baseline", action="store_true",
                    help="regenerate the default baseline file in place "
                         "(torch_lint_baseline.json, or the trace baseline "
                         "under --trace) and exit 0")
    ap.add_argument("--select", default=None, metavar="R001,R004",
                    help="run only these rule ids (or contract ids under "
                         "--trace)")
    ap.add_argument("--format", choices=("text", "json", "sarif"),
                    default="text")
    ap.add_argument("--no-cache", action="store_true",
                    help="disable the incremental AST cache "
                         "(.torch_lint_cache.json)")
    ap.add_argument("--cache-file", default=None, metavar="FILE",
                    help="incremental cache location (default: "
                         ".torch_lint_cache.json in the current directory)")
    ap.add_argument("--load", action="append", default=[], metavar="PYFILE",
                    help="(trace tier) exec extra contract-registration "
                         "files before running — used to plant fixture "
                         "violations in tests")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.trace:
        from .trace_lint import run_trace
        return run_trace(args)

    rules = active_rules()
    if args.list_rules:
        for r in rules:
            print(f"{r.rule_id}  {r.summary}")
        return 0
    if args.select:
        wanted = {s.strip().upper() for s in args.select.split(",")}
        unknown = wanted - {r.rule_id for r in rules}
        if unknown:
            print(f"unknown rule id(s): {', '.join(sorted(unknown))}",
                  file=sys.stderr)
            return 2
        rules = [r for r in rules if r.rule_id in wanted]

    cache = None
    if not args.no_cache:
        from .lint_cache import LintCache, DEFAULT_CACHE
        cache = LintCache(args.cache_file or DEFAULT_CACHE)

    findings, errors = lint_paths(args.paths, rules=rules, cache=cache)
    for err in errors:
        print(f"torch-lint: {err}", file=sys.stderr)

    if args.update_baseline:
        args.write_baseline = args.baseline or DEFAULT_BASELINE
    if args.write_baseline:
        fresh = Baseline.from_findings(findings)
        if os.path.exists(args.write_baseline):
            try:                        # keep the audited entries' reasons
                fresh.reasons = Baseline.load(args.write_baseline).reasons
            except (OSError, ValueError, KeyError):
                pass
        fresh.dump(args.write_baseline)
        print(f"torch-lint: wrote {len(findings)} finding(s) to "
              f"{args.write_baseline}")
        return 0

    linted_rels = {os.path.relpath(p).replace(os.sep, "/")
                   for p in _iter_py_files(args.paths)}
    baseline_path = _resolve_baseline(args.baseline, args.no_baseline)
    stale = []
    if baseline_path:
        try:
            baseline = Baseline.load(baseline_path)
        except (OSError, ValueError, KeyError) as e:
            print(f"torch-lint: cannot load baseline {baseline_path}: {e}",
                  file=sys.stderr)
            return 2
        findings = [f for f in findings if not baseline.suppresses(f)]
        stale = stale_baseline_entries(baseline, linted_rels)

    if args.format == "json":
        print(json.dumps(
            {"findings": [asdict(f) for f in findings],
             "errors": errors,
             "stale_baseline": [
                 {"file": k[0], "rule": k[1], "snippet": k[2], "count": n}
                 for k, n in stale]}, indent=1))
    elif args.format == "sarif":
        from .sarif import render
        print(render(findings, "torch-lint", rules=rules, errors=errors))
    else:
        for f in findings:
            print(f.format())
        for (frel, rule, snippet), n in stale:
            print(f"{frel}: stale baseline entry for {rule} "
                  f"(x{n}) no longer matches any finding: {snippet!r} — "
                  f"remove it or run --update-baseline")
        n = len(findings)
        suffix = f" (baseline: {baseline_path})" if baseline_path else ""
        print(f"torch-lint: {n} finding(s){suffix}"
              + (f", {len(stale)} stale baseline entrie(s)" if stale else ""))
    if errors:
        return 2
    return 1 if findings or stale else 0
