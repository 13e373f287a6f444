"""Incremental cache for the torch-lint AST tier (`.torch_lint_cache.json`),
a copy of ``lightgbm_tpu/analysis/lint_cache.py``.

Most runs see an unchanged tree. The cache keys each file by a sha256 of its content and
the whole run by a *package fingerprint* — a hash over the sorted
(relpath, content-hash) pairs — because the reachability rules
(R007/R009/R012, ``cross_module = True``) produce findings that depend on
OTHER files' contents:

- package fingerprint unchanged  -> every finding replays from the cache
  with **zero** ``ast.parse`` calls (the common verify-loop case);
- fingerprint changed            -> all files are parsed (the call graph
  needs every tree anyway), but per-file *local*-rule findings replay for
  files whose own hash is unchanged; cross-module rules re-run everywhere.

The cache also records the active rule-id list — a ``--select`` run neither
reads nor poisons a full-run cache. Findings are stored post-suppression
(pragmas live in file content, so the hash covers them). Parse errors are
never cached. The file is git-ignored; delete it any time.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Optional, Tuple

DEFAULT_CACHE = ".torch_lint_cache.json"
_SCHEMA = 1


def _sha(text: str) -> str:
    return hashlib.sha256(text.encode("utf-8", "surrogatepass")).hexdigest()


def _fingerprint(hashes: Dict[str, str]) -> str:
    blob = "\n".join(f"{rel}\0{h}" for rel, h in sorted(hashes.items()))
    return _sha(blob)


class LintCache:
    def __init__(self, path: str = DEFAULT_CACHE):
        self.path = path
        self.data = {"schema": _SCHEMA, "rules": [], "fingerprint": "",
                     "files": {}}
        self._hashes: Dict[str, str] = {}
        try:
            with open(path) as fh:
                loaded = json.load(fh)
            if loaded.get("schema") == _SCHEMA:
                self.data = loaded
        except (OSError, ValueError):
            pass

    # ------------------------------------------------------------- queries

    def _hash_sources(self, sources: List[Tuple[str, str, str]]
                      ) -> Dict[str, str]:
        self._hashes = {rel: _sha(src) for _, rel, src in sources}
        return self._hashes

    def replay(self, sources: List[Tuple[str, str, str]],
               rule_ids: List[str]) -> Optional[list]:
        """All findings for an unchanged package, or None on any miss."""
        hashes = self._hash_sources(sources)
        if self.data.get("rules") != list(rule_ids):
            return None
        if self.data.get("fingerprint") != _fingerprint(hashes):
            return None
        from .tpu_lint import Finding
        out = []
        for rel in sorted(hashes):
            entry = self.data["files"].get(rel)
            if entry is None:
                return None
            for d in entry.get("local", []) + entry.get("cross", []):
                out.append(Finding(**d))
        out.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
        return out

    def cached_local(self, rel: str, source: str,
                     rule_ids: Optional[List[str]] = None) -> Optional[list]:
        """Local-rule findings for one unchanged file, else None."""
        if rule_ids is not None and self.data.get("rules") != list(rule_ids):
            return None
        entry = self.data["files"].get(rel)
        if entry is None:
            return None
        h = self._hashes.get(rel) or _sha(source)
        if entry.get("hash") != h:
            return None
        from .tpu_lint import Finding
        return [Finding(**d) for d in entry.get("local", [])]

    # -------------------------------------------------------------- update

    def store(self, sources: List[Tuple[str, str, str]],
              rule_ids: List[str],
              per_file: Dict[str, tuple]) -> None:
        """Record this run: per_file maps rel -> (source, local, cross)."""
        from dataclasses import asdict
        hashes = self._hashes or self._hash_sources(sources)
        files = {}
        for rel, (source, local, cross) in per_file.items():
            files[rel] = {"hash": hashes.get(rel, _sha(source)),
                          "local": [asdict(f) for f in local],
                          "cross": [asdict(f) for f in cross]}
        self.data = {"schema": _SCHEMA, "rules": list(rule_ids),
                     "fingerprint": _fingerprint(
                         {r: files[r]["hash"] for r in files}),
                     "files": files}
        try:
            tmp = self.path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(self.data, fh)
            os.replace(tmp, self.path)
        except OSError:
            pass  # read-only checkout: caching is best-effort
