"""The manifest, and every file it names, load by name and keep the
contract's shape; a new cell needs only new files and entries."""
import json
import os
import re
import shutil

import pytest

from benchmark.harness import manifest
from benchmark.tests.conftest import ROOT, TINY, run_tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def man():
    return manifest.load_manifest(ROOT)


def test_manifest_has_the_contract_keys(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert man["command"] == ["python3", "benchmark/run.py"]
    assert man["paths"] == ["benchmark"]
    assert 1 <= man["run_seconds"] <= 51
    assert len(json.dumps(man)) <= 64 * 1024
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert len(w["why"]) <= 200
    for m in man["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in man["end_to_end"]}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in man[k]]
    for n in names:
        assert NAME.match(n), n
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in man[k]}) == len(man[k])
    metric_names = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)


@pytest.mark.parametrize("kind", ["configs", "workloads"])
def test_every_named_file_loads(man, kind):
    for entry in man[kind]:
        if kind == "configs":
            cfg = manifest.config(entry["name"])
            assert cfg["name"] == entry["name"]
            assert cfg["reduced"] == entry["reduced"]
            assert os.path.isfile(os.path.join(ROOT, entry["file"]))
        else:
            mix = manifest.traffic(entry["traffic"])
            assert manifest.driver(mix["driver"]).run
            assert manifest.limits(entry["name"])["limits"]
            assert entry["config"] in {c["name"] for c in man["configs"]}


def test_metric_readers_match_their_entries(man):
    e2e = {m["name"] for m in man["end_to_end"]}
    for m in man["per_layer"]:
        reader = manifest.metric_reader(m["name"])
        assert reader.UNIT == m["unit"] and UNIT.match(m["unit"])
        assert reader.SOURCE == m["source"] and m["source"] in SOURCES
        assert reader.LAYER == m["layer"]
        assert reader.MOVES == m["moves"] and m["moves"] in e2e
        # every cell that reports it reports the metric it moves
        moved = next(x for x in man["end_to_end"] if x["name"] == m["moves"])
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", [cell])


# the direction a metric's kind implies: times, idle shares and syncs are
# better lower; rates, roofline and peak shares better higher
LOWER = (lambda m: m["unit"] in ("s", "ms", "us", "ns")
         or "idle" in m["name"] or "syncs" in m["unit"])
HIGHER = (lambda m: m["unit"].endswith("/s") or "roofline" in m["name"]
          or "mfu" in m["name"])


def test_every_metric_points_the_way_its_kind_does(man):
    for m in man["end_to_end"] + man["per_layer"]:
        assert m["better"] in ("lower", "higher")
        assert not (LOWER(m) and HIGHER(m)), m["name"]
        if LOWER(m):
            assert m["better"] == "lower", m["name"]
        elif HIGHER(m):
            assert m["better"] == "higher", m["name"]
    idle = [m for m in man["per_layer"] if "idle" in m["name"]]
    assert idle and all(m["better"] == "lower" for m in idle)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer(man):
    for w in man["workloads"]:
        e2e = [m["name"] for m in manifest.metrics_of(man, w["name"],
                                                      "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.metrics_of(man, w["name"], "per_layer")


DUMMY_GENERATOR = '''
import torch


def rows(n, spec, gen, device):
    K = int(spec["levels"])
    u = torch.rand((n, int(spec["features"])), generator=gen, device=device)
    X = (torch.floor(u * K) + 0.5) / K
    noise = 0.3 * torch.randn(n, generator=gen, device=device)
    return X, (X[:, 0] - X[:, 1] + noise > 0).float()


def training_data(spec, gen, device):
    X, y = rows(int(spec["train_rows"]), spec, gen, device)
    Xv, yv = rows(int(spec["valid_rows"]), spec, gen, device)
    return {"X": X, "y": y, "Xv": Xv, "yv": yv}
'''


def test_a_cell_is_added_by_files_and_entries_alone(tmp_path):
    """A dummy configuration with a data generator of its own, a traffic
    mix, a per-layer metric and limits, added as new files with new
    manifest entries, run through the same harness without an edit to any
    file that was there."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark")
    man = manifest.load_manifest(ROOT)
    bench = root / "benchmark"
    cfg = manifest.config("higgs")
    cfg["name"] = "dummy"
    cfg["data"] = {"generator": "dummy_uniform", "train_rows": 9000,
                   "valid_rows": 2000, "features": 6, "levels": 40}
    (bench / "generators" / "dummy_uniform.py").write_text(DUMMY_GENERATOR)
    (bench / "configs" / "dummy.json").write_text(json.dumps(cfg))
    mix = dict(manifest.traffic("train"), check_trees=1)
    (bench / "traffic" / "dummy_train.json").write_text(json.dumps(mix))
    (bench / "limits" / "dummy.dummy_train.json").write_text(json.dumps(
        manifest.limits("higgs.train")))
    (bench / "metrics" / "dummy_iterations.py").write_text(
        'UNIT = "count"\nSOURCE = "host_clock"\nLAYER = "engine"\n'
        'MOVES = "train_iter_ms"\n\n\ndef read(ctx):\n'
        '    return ctx["record"]["iterations"]\n')
    man["configs"].append(dict(man["configs"][0], name="dummy",
                               file="benchmark/configs/dummy.json"))
    man["workloads"].append({"name": "dummy.dummy_train", "config": "dummy",
                             "traffic": "dummy_train", "chips": 1,
                             "why": "a dummy cell"})
    man["end_to_end"][0]["workloads"].append("dummy.dummy_train")
    man["per_layer"].append({"name": "dummy_iterations", "unit": "count",
                             "better": "higher", "source": "host_clock",
                             "layer": "engine", "moves": "train_iter_ms",
                             "workloads": ["dummy.dummy_train"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    import benchmark.tests.conftest as cf
    cf.TINY["dummy.dummy_train"] = TINY["higgs.train"]
    try:
        res = run_tiny("dummy.dummy_train", trace=True, root=str(root))
    finally:
        del cf.TINY["dummy.dummy_train"]
    assert res["metrics"]["dummy_iterations"]["value"] >= 1
    assert res["correct"] is True
