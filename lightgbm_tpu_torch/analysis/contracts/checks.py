"""Predicate checks for the op-trace contracts (the port of
``lightgbm_tpu/analysis/contracts/checks.py``).

Each check exposes ``run(program) -> list[str]`` where every failure
message starts with a stable kind token (``forbidden-op``,
``required-collective``, ``dtype``, ``host-transfer``, ``count``,
``kernel``) — the token is the baseline fingerprint component, so message
wording can evolve without rotting baselines.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

from .registry import TracedProgram

# collective_bytes() key prefix -> the Collectives method it is charged to
# (parallel/comm.py: psum_root_scalars, psum_scatter_hist, allgather_splits,
# the voting learner's psum_votes / psum_selected)
COLLECTIVE_KINDS: Dict[str, str] = {
    "psum_scatter": "reduce_scatter",
    "reduce_scatter": "reduce_scatter",
    "allgather": "all_gather",
    "all_gather": "all_gather",
    "psum": "all_reduce",
    "all_reduce": "all_reduce",
}


def _prefix_to_kind(key: str) -> Optional[str]:
    best = None
    for prefix, kind in COLLECTIVE_KINDS.items():
        if key.startswith(prefix) and (best is None
                                       or len(prefix) > len(best[0])):
            best = (prefix, kind)
    return best[1] if best else None


class ForbidOps:
    """Named aten operations must not appear over an input of
    ``min_numel`` elements or more: "no sort over rows" is not tripped by
    the ``[L]``-sized stable sort of the leaf gains."""

    def __init__(self, names: Iterable[str], min_numel: int = 0):
        self.names = frozenset(names)
        self.min_numel = int(min_numel)

    def run(self, p: TracedProgram):
        out, seen = [], set()
        for r in p.trace.ops:
            if r.name in self.names and r.numel >= self.min_numel \
                    and (r.name, r.site) not in seen:
                seen.add((r.name, r.site))
                out.append(f"forbidden-op: `{r.name}` over {r.numel} "
                           f"elements at {r.site}")
        return out


class CountOp:
    """An operation must appear exactly ``expect`` times (one batched
    ``cholesky_ex`` per linear fit: a second means the solve was repeated
    instead of batched)."""

    def __init__(self, name: str, expect: int):
        self.name = name
        self.expect = int(expect)

    def run(self, p: TracedProgram):
        n = p.trace.count(self.name)
        if n != self.expect:
            return [f"count: `{self.name}` appears {n}x, contract pins "
                    f"exactly {self.expect}"]
        return []


class CountKernelLaunches:
    """The histogram kernel (B1) runs exactly the passes the program
    expects: counted on the card by ``cuda_histogram.launch_count()``
    (``kernel_launches``), on the CPU by the recorder's plain passes."""

    def run(self, p: TracedProgram):
        if p.expected_launches is None:
            return ["kernel: the builder states no expected pass count"]
        got = p.kernel_launches if p.kernel_launches is not None \
            else p.trace.kernel_passes
        if got != p.expected_launches:
            return [f"kernel: {got} histogram passes, expected "
                    f"{p.expected_launches}"]
        return []


class DtypeDiscipline:
    """No silent f64: a ``float64`` (or ``complex128``) value may appear
    only at the sites of the explicit allowlist — ``relpath:function``
    of the port's deliberate f64 (the split scan's prefix sums, C11; B1's
    ``[2]`` scales; voting's f64 reductions, C25; the root sums' f64
    partials), or in an operation the allowlist names (the histogram
    kernel, which reads the scales)."""

    def __init__(self, allow: Iterable[str] = (),
                 forbid: Tuple[str, ...] = ("float64", "complex128")):
        self.allow = frozenset(allow)
        self.forbid = frozenset(forbid)

    def run(self, p: TracedProgram):
        out, seen = [], set()
        for r in p.trace.ops:
            bad = self.forbid & (set(r.dtypes) | set(r.out_dtypes))
            if not bad or r.site in self.allow or r.name in self.allow \
                    or r.site in seen:
                continue
            seen.add(r.site)
            out.append(f"dtype: `{sorted(bad)[0]}` in `{r.name}` at "
                       f"{r.site}, outside the f64 allowlist")
        return out


class NoHostTransfer:
    """Nothing in the recorded region reads the card on the host or
    writes a host value into it (``op_trace`` host kinds)."""

    def run(self, p: TracedProgram):
        out, seen = [], set()
        for r in p.trace.host_transfers():
            if (r.name, r.site) in seen:
                continue
            seen.add((r.name, r.site))
            out.append(f"host-transfer: `{r.name}` ({r.host}) at {r.site}")
        return out


class RequiredCollectives:
    """The collectives the program's comm strategy charges in
    ``collective_bytes()`` (by key prefix) must all run, counted at the
    ``parallel/comm.Collectives`` surface, and none it does not charge may
    run (an undeclared collective means the cost model under-reports the
    wire)."""

    def run(self, p: TracedProgram):
        if p.comm is None or p.collectives is None:
            return ["required-collective: the target supplies no comm "
                    "charges or collective counts"]
        declared = p.comm() if callable(p.comm) else p.comm
        expected = {k for k in (_prefix_to_kind(str(key))
                                for key in declared) if k}
        present = {k for k, n in p.collectives.items() if n}
        out = []
        for k in sorted(expected - present):
            out.append(f"required-collective: `{k}` charged by "
                       f"collective_bytes() but never run")
        for k in sorted(present - expected):
            out.append(f"required-collective: undeclared `{k}` ran — "
                       f"collective_bytes() does not charge it")
        return out
