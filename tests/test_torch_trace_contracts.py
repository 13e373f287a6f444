"""The op-trace tier of torch-lint (``lightgbm_tpu_torch/analysis/contracts``
and ``trace_lint.py``) on the CPU.

- Every carried contract (T001, T003, T004, T006, T007, T009, T010) is
  clean on the port's shipped programs, except T007's one finding, which
  ``torch_trace_baseline.json`` records (ROADMAP A14b).
- Every ``violates`` pin fails its check, and a pin that stops failing is
  reported ("sensitivity lost").
- A planted program fires each check kind (``tests/fixtures/torch_lint/
  trace_violations.py``); the CLI gates on it, writes and reads baselines,
  reports stale entries and renders SARIF.
- T003 in a gloo world of two processes (``tests/_torch_world.py``).
- Parity: at the serial shape class T001, T004 and T010 give the JAX tier's
  verdict (``lightgbm_tpu.analysis.contracts``) on the JAX tier's own
  seeded inputs, and T001's sensitivity pins (the JAX package's
  ``incremental_partition=false``, the port's ``tpu_row_compact=false``)
  both violate.
"""
import json
import os
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.analysis.contracts import (CONTRACTS, Target,
                                                   TracedProgram,
                                                   build_program, evaluate,
                                                   evaluate_target, get_entry)
from lightgbm_tpu_torch.analysis.contracts import entries as E
from lightgbm_tpu_torch.analysis.contracts.op_trace import OpTrace, record

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_world import run_world  # noqa: E402

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
FIXTURE = os.path.join(HERE, "fixtures", "torch_lint", "trace_violations.py")
CARRIED = ("T001", "T003", "T004", "T006", "T007", "T009", "T010")


def _cell(cid, shape_class):
    c = CONTRACTS[cid]
    t = next(t for t in c.targets if t.shape_class == shape_class)
    return c, t, build_program(c.entry, shape_class)


def test_the_carried_contracts_and_no_others():
    shipped = sorted(c for c in CONTRACTS if not c.startswith("TX"))
    assert tuple(shipped) == CARRIED


def test_entry_points_are_the_shipped_callables():
    from lightgbm_tpu_torch import grower
    from lightgbm_tpu_torch.boosting.gbdt import GBDT
    from lightgbm_tpu_torch.ops import linear, predict
    assert get_entry("grower.wave") is grower.TreeGrower.wave
    assert get_entry("grower.stream_legs") is grower.StreamedGrower
    assert get_entry("linear.fit") is linear.fit_linear_leaves
    assert get_entry("predict.forest_walk") is predict.forest_walk_leaves
    assert get_entry("boosting.part_start") is GBDT._part_start
    assert get_entry("boosting.part_tree") is GBDT._part_tree
    assert get_entry("boosting.part_tree_end") is GBDT._part_tree_end


@pytest.mark.parametrize("cid", [c for c in CARRIED if c != "T003"])
def test_shipped_contract_holds_on_every_target(cid):
    """Clean everywhere (a violates pin's failure is its expected outcome),
    but T007 at stream_shard, whose one finding is the baseline's."""
    c = CONTRACTS[cid]
    base = json.load(open(os.path.join(REPO, "torch_trace_baseline.json")))
    baselined = {e["snippet"] for e in base["findings"]}
    for t in c.targets:
        findings = evaluate(c, t, build_program(c.entry, t.shape_class))
        if (cid, t.shape_class) == ("T007", "stream_shard"):
            assert [f for f, _ in findings] == \
                ["T007:grower.stream_legs@stream_shard:forbidden-op"]
            assert findings[0][0] in baselined
            assert "ops/histogram.py:pass_positions" in findings[0][1]
        else:
            assert findings == [], f"{cid}@{t.shape_class}: {findings}"


def test_the_trace_baseline_holds_only_t007():
    base = json.load(open(os.path.join(REPO, "torch_trace_baseline.json")))
    assert [(e["rule"], e["file"]) for e in base["findings"]] == \
        [("T007", "trace://grower.stream_legs@stream_shard")]
    assert "A14b" in base["findings"][0]["reason"]


def test_violates_pins_actually_violate():
    c, t, program = _cell("T001", "nopartition")
    assert t.expect == "violates"
    failures = evaluate_target(c, program)
    assert failures and all("pass_positions" in f for f in failures)
    assert evaluate(c, t, program) == []


def test_lost_sensitivity_is_reported():
    c, _t, program = _cell("T001", "serial")
    findings = evaluate(c, Target("serial", "violates"), program)
    assert len(findings) == 1
    assert findings[0][0].endswith(":sensitivity")
    assert "sensitivity lost" in findings[0][1]


def test_wave_programs_count_one_histogram_pass_per_wave():
    _, _, program = _cell("T006", "serial")
    assert program.trace.waves >= 2
    assert program.trace.kernel_passes == program.trace.waves
    assert program.trace.count("kernel:histogram") == program.trace.waves
    _, _, waves = _cell("T001", "serial")
    assert waves.trace.kernel_passes == waves.trace.waves


def test_the_leaf_gain_sort_is_below_the_row_bound():
    """The wave does sort — the [L+1] leaf gains — and T001's minimum size
    keeps that legal, while the pin's row sort is over every row."""
    _, _, serial = _cell("T001", "serial")
    _, _, pin = _cell("T001", "nopartition")
    small = [r.numel for r in serial.trace.ops if r.name == "sort"]
    rows = [r.numel for r in pin.trace.ops if r.name == "sort"
            and r.site == "ops/histogram.py:pass_positions"]
    assert small and max(small) == E.N_LEAVES + 1 < E.ROW_SORT_MIN
    assert rows and min(rows) == E.N_ROWS


def test_recorder_counts_host_reads_and_keeps_the_kernel_opaque():
    t = torch.arange(6.0)
    with record() as trace:
        t.sum().item()
        int(t[2])
        t.tolist()
        u = t.clone()
        u[0] = 0.5
        torch.nonzero(t)
    kinds = [r.host for r in trace.host_transfers()]
    assert kinds.count("scalar read") == 2
    assert "host read" in kinds and "host scalar" in kinds
    assert "data-dependent shape" in kinds
    with record() as trace:
        torch.from_numpy(np.zeros((64, 4), np.uint8))      # host memory
    assert trace.host_transfers() == []


def _planted():
    runpy.run_path(FIXTURE, run_name="trace_fixture_test")


def test_planted_fixture_violations_fire():
    _planted()
    expected = {"TX90": "forbidden-op", "TX91": "required-collective",
                "TX92": "dtype", "TX93": "host-transfer", "TX94": "count",
                "TX95": "kernel"}
    for cid, kind in expected.items():
        c = CONTRACTS[cid]
        t = c.targets[0]
        findings = evaluate(c, t, build_program(c.entry, t.shape_class))
        assert findings, f"{cid}: planted violation did not fire"
        assert {f.rsplit(":", 1)[1] for f, _ in findings} == {kind}
    msgs = [m for _, m in evaluate(CONTRACTS["TX91"],
                                   CONTRACTS["TX91"].targets[0],
                                   build_program("fixture.planted",
                                                 "collectives"))]
    assert any("reduce_scatter" in m and "never run" in m for m in msgs)
    assert any("undeclared `all_reduce`" in m for m in msgs)


# ----------------------------------------------------------------- CLI

def _cli(*argv, timeout=600):
    return subprocess.run(
        [sys.executable, "-m", "lightgbm_tpu_torch.analysis", "--trace",
         *argv], cwd=REPO, capture_output=True, text=True, timeout=timeout)


def test_cli_planted_violations_gate_exit():
    r = _cli("--load", FIXTURE, "--select",
             "TX90,TX91,TX92,TX93,TX94,TX95", "--format", "json",
             "--no-baseline")
    assert r.returncode == 1, r.stderr
    data = json.loads(r.stdout)
    kinds = {f["snippet"].rsplit(":", 1)[1] for f in data["findings"]}
    assert kinds == {"forbidden-op", "required-collective", "dtype",
                     "host-transfer", "count", "kernel"}


def test_cli_baseline_stale_entry_and_sarif(tmp_path):
    base = tmp_path / "trace_base.json"
    r = _cli("--select", "T007", "--update-baseline", "--baseline",
             str(base))
    assert r.returncode == 0, r.stderr
    entries = json.load(open(base))["findings"]
    assert [e["rule"] for e in entries] == ["T007"]
    assert _cli("--select", "T007", "--baseline", str(base)).returncode == 0
    # an entry that no longer matches a finding of an evaluated cell
    entries.append(dict(entries[0], snippet="T007:grower.stream_legs@"
                                            "stream_wave:dtype"))
    json.dump({"version": 1, "findings": entries}, open(base, "w"))
    r = _cli("--select", "T007", "--baseline", str(base))
    assert r.returncode == 1
    assert "stale baseline entry for T007" in r.stdout
    r = _cli("--select", "T007", "--no-baseline", "--format", "sarif")
    assert r.returncode == 1
    doc = json.loads(r.stdout)
    run = doc["runs"][0]
    assert run["tool"]["driver"]["name"] == "torch-lint-trace"
    assert [res["ruleId"] for res in run["results"]] == ["T007"]


def test_cli_whole_tier_is_clean_against_the_committed_baseline():
    r = _cli()
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 finding(s)" in r.stdout and "stale" not in r.stdout


# ------------------------------------------------- T003 in a world of two

T003_SCRIPT = r'''
import json, sys
import torch
torch.set_num_threads(1)
spec = json.load(open(sys.argv[1])); rank = int(sys.argv[2])
from lightgbm_tpu_torch.analysis.contracts import entries as E
res = E.data_parallel_wave(spec["machines"], spec["ports"][rank],
                           spec["world"])
json.dump(res, open(spec["out"].format(rank=rank), "w"))
'''


def test_t003_data_parallel_collectives_in_a_gloo_world(tmp_path):
    outs = run_world(T003_SCRIPT, 2, {}, str(tmp_path))
    c = CONTRACTS["T003"]
    for res in outs:
        assert res["strategy"] == "data"
        assert res["collectives"]["reduce_scatter"] == res["waves"]
        program = E.program_from_rank(res, "data2")
        assert evaluate(c, c.targets[0], program) == []
    # the same program with a collective the cost model does not charge
    bad = E.program_from_rank(dict(outs[0], collectives=dict(
        outs[0]["collectives"], all_reduce=0)), "data2")
    assert evaluate_target(c, bad)


# ------------------------------------------------- parity with the JAX tier

def _jax_programs():
    import lightgbm_tpu.analysis.contracts.entries  # noqa: F401
    from lightgbm_tpu.analysis.contracts import CONTRACTS as JC
    from lightgbm_tpu.analysis.contracts import build_program as jbuild
    from lightgbm_tpu.analysis.contracts import evaluate_target as jeval
    return JC, jbuild, jeval


def _port_wave_on_jax_inputs(incremental: bool):
    """The JAX tier's ``grower.wave_body`` inputs (``_wave_program``:
    RandomState(0) codes [1024, 6] below 16, standard-normal g, unit h)
    through the port's shipped wave, with the JAX spec's values."""
    from lightgbm_tpu_torch.grower import GrowerSpec, TreeGrower
    N, F, B = 1024, 6, 16
    rng = np.random.RandomState(0)
    X = torch.as_tensor(rng.randint(0, B, size=(N, F)).astype(np.uint8))
    g = torch.as_tensor(rng.randn(N).astype(np.float32))
    spec = GrowerSpec(num_leaves=15, num_features=F, num_bins_padded=B,
                      hist_slots=4, wave_size=4, max_depth=0, lambda_l1=0.0,
                      lambda_l2=0.0, min_data_in_leaf=5.0,
                      min_sum_hessian_in_leaf=1e-3, min_gain_to_split=0.0,
                      row_compact=incremental)
    zeros = torch.zeros(F, dtype=torch.int32)
    grower = TreeGrower(X, torch.zeros(F, dtype=torch.bool),
                        torch.full((F,), B, dtype=torch.int32), zeros,
                        zeros, spec)
    ones = torch.ones(N)
    trace = E.record_waves(grower, g, ones, ones,
                           torch.ones(F, dtype=torch.bool))
    return TracedProgram("grower.wave", "serial", trace)


@pytest.mark.parametrize("cid,jax_class,port_incremental", [
    ("T001", "serial", True), ("T001", "serial_legacy", False),
    ("T004", "serial", True)])
def test_wave_verdicts_equal_the_jax_tier(cid, jax_class, port_incremental):
    JC, jbuild, jeval = _jax_programs()
    jc = JC[cid]
    jax_fails = bool(jeval(jc, jbuild(jc.entry, jax_class)))
    program = _port_wave_on_jax_inputs(port_incremental)
    c = CONTRACTS[cid]
    if cid == "T001":
        # the port's pin needs a sort over at least half of these rows
        c = type(c)(**{**c.__dict__, "checks": (
            E.C.ForbidOps(c.checks[0].names, min_numel=512),)})
    port_fails = bool(evaluate_target(c, program))
    assert port_fails == jax_fails == (jax_class == "serial_legacy")


def test_forest_walk_verdict_equals_the_jax_tier():
    """T010 on the JAX tier's walk inputs (zeros of its shapes: 3 trees of
    6 nodes, 32 rows of 4 features) through the port's shipped walk."""
    JC, jbuild, jeval = _jax_programs()
    jc = JC["T010"]
    jax_fails = bool(jeval(jc, jbuild(jc.entry, "serial")))
    T, N, F, M = 3, 32, 4, 6
    i32 = torch.int32
    z = torch.zeros((T, M), dtype=i32)
    walk = get_entry("predict.forest_walk")
    with record() as trace:
        walk(z, z, z, z, z, torch.zeros(T, dtype=torch.bool),
             torch.zeros(F, dtype=i32), torch.zeros((N, F), dtype=i32),
             torch.zeros((N, F), dtype=torch.bool),
             torch.zeros((N, F), dtype=torch.bool), 4)
    c = CONTRACTS["T010"]
    port_fails = bool(evaluate_target(
        c, TracedProgram("predict.forest_walk", "serial", trace)))
    assert port_fails == jax_fails is False
    assert len(trace.ops) > 0 and OpTrace().ops == []
