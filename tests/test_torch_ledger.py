"""The port's perf ledger (``lightgbm_tpu_torch/observability/ledger.py``)
against the JAX package's, on the CPU.

Pins:

- ``normalize_bench`` / ``normalize_multichip`` give the JAX package's
  entries on the payloads of every checked-in ``BENCH_r*.json`` /
  ``MULTICHIP_r*.json`` (read, never written);
- ``compare`` gives the JAX package's problems and notes on the same
  candidates against the same history (up to the files' names);
- ``build_ledger`` over a temporary directory of ``CUDA_r*.json`` /
  ``CUDA_MULTI_r*.json`` copies equals the JAX package's over the
  originals up to ``source``, and reads none of the JAX package's prefixes
  placed beside them, nor ``PERF_LEDGER.json`` / ``PERF_LEDGER.jsonl``;
- the port's ledger file is ``CUDA_LEDGER.json``: ``--rebuild`` writes it,
  ``--check`` fails when the history moved on.
"""
import glob
import json
import os
import shutil

import pytest
import torch

from lightgbm_tpu.observability import ledger as jledger
from lightgbm_tpu_torch.observability import ledger

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
BENCH = sorted(os.path.basename(p)
               for p in glob.glob(os.path.join(REPO, "BENCH_r*.json")))
MULTI = sorted(os.path.basename(p)
               for p in glob.glob(os.path.join(REPO, "MULTICHIP_r*.json")))


def _port_name(name):
    return name.replace("MULTICHIP_r", "CUDA_MULTI_r").replace(
        "BENCH_r", "CUDA_r")


@pytest.fixture(scope="module")
def histories(tmp_path_factory):
    """The originals beside each other, and the same payloads under the
    port's prefixes (with the JAX prefixes and the JAX package's ledgers
    planted beside them)."""
    jdir = tmp_path_factory.mktemp("jax_history")
    pdir = tmp_path_factory.mktemp("port_history")
    for name in BENCH + MULTI:
        shutil.copy(os.path.join(REPO, name), jdir / name)
        shutil.copy(os.path.join(REPO, name), pdir / _port_name(name))
    shutil.copy(os.path.join(REPO, BENCH[-1]), pdir / "BENCH_r1.json")
    shutil.copy(os.path.join(REPO, MULTI[-1]), pdir / "MULTICHIP_r7.json")
    (pdir / "STREAM_r08.json").write_text(json.dumps({"value": 1.0}))
    (pdir / "PERF_LEDGER.json").write_text("{}")
    (pdir / "PERF_LEDGER.jsonl").write_text("{}\n")
    return str(jdir), str(pdir)


def _unsourced(entries):
    out = []
    for e in entries:
        e = dict(e)
        e.pop("source")
        out.append(e)
    return sorted(out, key=lambda e: (e["round"] or 0, e["kind"]))


@pytest.mark.parametrize("name", BENCH)
def test_normalize_bench_matches_jax(name):
    payload = jledger.payload_of(os.path.join(REPO, name))
    assert ledger.payload_of(os.path.join(REPO, name)) == payload
    r = ledger._round_of(name)
    assert ledger.normalize_bench(payload, name, r) == \
        jledger.normalize_bench(payload, name, r)


@pytest.mark.parametrize("name", MULTI)
def test_normalize_multichip_matches_jax(name):
    payload = jledger.payload_of(os.path.join(REPO, name))
    r = ledger._round_of(name)
    assert ledger.normalize_multichip(payload, name, r) == \
        jledger.normalize_multichip(payload, name, r)


def test_build_ledger_matches_jax_up_to_source(histories):
    jdir, pdir = histories
    theirs = jledger.build_ledger(jdir)
    ours = ledger.build_ledger(pdir)
    assert _unsourced(ours["entries"]) == _unsourced(theirs["entries"])
    assert {e["source"] for e in ours["entries"]} == \
        {_port_name(n) for n in BENCH + MULTI}
    for key in ("best", "best_multichip"):
        assert set(ours[key]) == set(theirs[key])
        for k in ours[key]:
            a, b = dict(ours[key][k]), dict(theirs[key][k])
            assert a.pop("source") == _port_name(b.pop("source"))
            assert a == b
    assert ours["baseline_mrow_tree_per_s"] == \
        theirs["baseline_mrow_tree_per_s"]
    assert ours["version"] == theirs["version"]


CANDIDATES = [
    {"metric": "higgs_train_throughput", "value": 3.0, "unit": "Mrow-tree/s",
     "platform": "tpu", "rows": 10_500_000, "kernel": "xla"},
    {"metric": "higgs_train_throughput", "value": 5.8, "unit": "Mrow-tree/s",
     "platform": "tpu", "rows": 10_500_000, "kernel": "xla"},
    {"value": 0.0, "error": "dead tunnel"},
    {"value": 4.0, "platform": "tpu", "rows": 2_100_000},
    {"value": 6.0, "platform": "tpu", "rows": 10_500_000, "kernel": "xla",
     "recompiles_post_warmup": 2, "hbm_peak_gb": 99.0,
     "phase_timings": {"headline": {"host_syncs": 40}}},
    {"metric": "multichip_scaling", "per_chip_mrow_tree_per_s": 0.01,
     "platform": "cpu", "n_devices": 8},
]


@pytest.mark.parametrize("i", range(len(CANDIDATES)))
def test_compare_matches_jax(histories, i):
    jdir, pdir = histories
    cand = CANDIDATES[i]
    theirs = jledger.compare(dict(cand), jledger.load_history(jdir))
    ours = ledger.compare(dict(cand), ledger.load_history(pdir))

    def renamed(msgs):
        out = []
        for m in msgs:
            for n in BENCH + MULTI:
                m = m.replace(_port_name(n), n)
            out.append(m)
        return out
    assert (renamed(ours[0]), renamed(ours[1])) == theirs
    if i == 0:
        assert any("throughput regression" in p for p in ours[0])


def test_compare_flags_recompile_and_cost_drift():
    entries = [ledger.normalize_bench(
        {"value": 6.0, "platform": "gpu", "rows": 100,
         "recompiles_post_warmup": 0, "hbm_peak_gb": 2.0,
         "phase_timings": {"headline": {"host_syncs": 1}},
         "telemetry": {"cost_reports": {
             "train_step.k4": {"flops": 1e9, "bytes_accessed": 1e8}}}},
        "CUDA_r90.json", 90)]
    cand = {"value": 6.0, "platform": "gpu", "rows": 100,
            "recompiles_post_warmup": 2, "hbm_peak_gb": 3.0,
            "phase_timings": {"headline": {"host_syncs": 4}},
            "telemetry": {"cost_reports": {
                "train_step.k4": {"flops": None, "bytes_accessed": 1e8}}}}
    problems, _ = ledger.compare(cand, entries)
    text = "\n".join(problems)
    assert "recompile regression" in text
    assert "host-sync regression" in text
    assert "peak-HBM regression" in text
    assert "train_step.k4.flops" in text and "None" in text


def test_ledger_file_and_prefixes():
    assert ledger.LEDGER_FILE == "CUDA_LEDGER.json"
    assert (ledger.BENCH_GLOB, ledger.MULTICHIP_GLOB) == \
        ("CUDA_r*.json", "CUDA_MULTI_r*.json")
    src = open(ledger.__file__).read()
    for name in ("BENCH_r*", "MULTICHIP_r*", "STREAM_r*", "SERVE_r*"):
        assert f'"{name}.json"' not in src


def test_rebuild_and_check(tmp_path, capsys):
    src = {"metric": "higgs_train_throughput", "value": 5.0,
           "platform": "gpu", "rows": 100}
    (tmp_path / "CUDA_r01.json").write_text(json.dumps(src))
    (tmp_path / "PERF_LEDGER.json").write_text('{"untouched": true}')
    assert ledger.main(["--root", str(tmp_path), "--rebuild"]) == 0
    assert ledger.main(["--root", str(tmp_path), "--check"]) == 0
    assert os.path.exists(tmp_path / "CUDA_LEDGER.json")
    assert json.load(open(tmp_path / "PERF_LEDGER.json")) == \
        {"untouched": True}
    (tmp_path / "CUDA_r02.json").write_text(json.dumps(dict(src, value=6.0)))
    assert not ledger.check_ledger(str(tmp_path))   # history moved on
    assert ledger.main(["--root", str(tmp_path), "--check"]) == 1
    ledger.write_ledger(str(tmp_path))
    assert ledger.check_ledger(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == [
        "CUDA_LEDGER.json", "CUDA_r01.json", "CUDA_r02.json",
        "PERF_LEDGER.json"]
    capsys.readouterr()


def test_ledger_wrapper_and_flat_payloads(tmp_path):
    (tmp_path / "CUDA_r01.json").write_text(json.dumps(
        {"n": 1, "cmd": "x", "rc": 1, "parsed": None}))
    (tmp_path / "CUDA_r02.json").write_text(json.dumps(
        {"n": 2, "rc": 0, "parsed": {"metric": "m", "value": 1.5,
                                     "platform": "gpu"}}))
    entries = ledger.load_history(str(tmp_path))
    assert entries[0]["error"] and entries[0]["value"] is None
    assert entries[1]["value"] == 1.5
