"""torch-lint self-tests (``lightgbm_tpu_torch/analysis``, the AST tier):
every rule R001-R013 fires on its planted fixture (and only its rule) and
not on the fixture's clean twin; suppressions work at all three levels
(inline pragma, file pragma, baseline) and stale baseline entries fail;
SARIF, the cache and the exit codes; the port's own tree lints clean
against the committed ``torch_lint_baseline.json``.

Parity with the JAX package's linter (``lightgbm_tpu/analysis``, whose AST
tier imports no JAX): on the same sources, the rules whose meaning carries
unchanged (R008, R010, R012) give the same findings (rule, line, column),
and the engine's pragma handling, baseline fingerprints and SARIF
structure agree.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from lightgbm_tpu.analysis import tpu_lint as jax_lint
from lightgbm_tpu.analysis import rules as jax_rules
from lightgbm_tpu.analysis import sarif as jax_sarif
from lightgbm_tpu_torch.analysis import tpu_lint as torch_lint
from lightgbm_tpu_torch.analysis import rules as torch_rules
from lightgbm_tpu_torch.analysis import sarif as torch_sarif
from lightgbm_tpu_torch.analysis.lint_cache import LintCache
from lightgbm_tpu_torch.analysis.tpu_lint import (Baseline, Finding,
                                                  lint_file, lint_paths, main)

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
FIXDIR = os.path.join(HERE, "fixtures", "torch_lint")
PKG = os.path.join(FIXDIR, "lightgbm_tpu_torch")
CLEAN = os.path.join(FIXDIR, "clean", "lightgbm_tpu_torch")

# (fixture path under lightgbm_tpu_torch/, the rule it must break)
BAD_FIXTURES = [
    ("boosting/bad_r001.py", "R001"),
    ("ops/bad_r002.py", "R002"),
    ("bad_r003.py", "R003"),
    ("ops/bad_r004.py", "R004"),
    ("boosting/bad_r005.py", "R005"),
    ("bad_r006.py", "R006"),
    ("bad_r007.py", "R007"),
    ("bad_r008.py", "R008"),
    ("boosting/bad_r009.py", "R009"),
    ("bad_r010.py", "R010"),
    ("serving/engine.py", "R011"),
    ("bad_r012.py", "R012"),
    ("bad_r013.py", "R013"),
]


@pytest.fixture(autouse=True)
def _isolated_default_cache(tmp_path, monkeypatch):
    """In-process main() calls must not read or write the repo's own
    .torch_lint_cache.json."""
    from lightgbm_tpu_torch.analysis import lint_cache
    monkeypatch.setattr(lint_cache, "DEFAULT_CACHE",
                        str(tmp_path / "lint_cache.json"))


def _rel(path):
    return os.path.relpath(path, FIXDIR).replace(os.sep, "/")


@pytest.mark.parametrize("relpath,rule", BAD_FIXTURES)
def test_bad_fixture_violates_exactly_its_rule(relpath, rule):
    findings, err = lint_file(os.path.join(PKG, relpath),
                              rel=_rel(os.path.join(PKG, relpath)))
    assert err is None
    assert findings, f"{relpath}: expected {rule} finding(s), got none"
    assert {f.rule for f in findings} == {rule}, \
        [f.format() for f in findings]


@pytest.mark.parametrize("relpath,rule", BAD_FIXTURES)
def test_clean_twin_has_no_findings(relpath, rule):
    path = os.path.join(CLEAN, relpath)
    rel = "lightgbm_tpu_torch/" + relpath
    findings, err = lint_file(path, rel=rel)
    assert err is None
    assert findings == [], [f.format() for f in findings]


def test_r004_names_the_count_and_the_kind():
    findings, _ = lint_file(os.path.join(PKG, "ops", "bad_r004.py"),
                            rel="lightgbm_tpu_torch/ops/bad_r004.py")
    assert len(findings) == 1
    assert "4 entries" in findings[0].message
    assert "takes 5" in findings[0].message


def test_r004_reads_the_ports_own_kernel_interface():
    """The shipped binding of csrc/histogram.cu matches; each of its
    argtypes lists, cut by one entry or with a kind swapped, fires."""
    from lightgbm_tpu_torch.analysis.rules.pallas_shapes import c_signatures
    sigs = c_signatures(os.path.join(REPO, "lightgbm_tpu_torch", "csrc"))
    assert sigs["gbdt_hist_build"][1][:4] == ["pointer", "int",
                                              "long long", "int"]
    assert len(sigs["gbdt_hist_acc_add"][1]) == 20
    assert sigs["LGBM_GetLastError"][0] == "pointer"     # the .c shim
    src = os.path.join(REPO, "lightgbm_tpu_torch", "ops",
                       "cuda_histogram.py")
    findings, _ = lint_file(src, rel="lightgbm_tpu_torch/ops/"
                                     "cuda_histogram.py")
    assert [f for f in findings if f.rule == "R004"] == []
    text = open(src).read()
    cut = text.replace("lib.gbdt_hist_acc_zero.argtypes = [p, i, i, i, p]",
                       "lib.gbdt_hist_acc_zero.argtypes = [p, i, i, p]")
    swapped = text.replace(
        "lib.gbdt_hist_acc_zero.argtypes = [p, i, i, i, p]",
        "lib.gbdt_hist_acc_zero.argtypes = [p, i, i, ll, p]")
    for variant in (cut, swapped):
        assert variant != text
        ctx = torch_lint._parse_source(src, "lightgbm_tpu_torch/ops/"
                                       "cuda_histogram.py", variant)
        hits = torch_lint._check_ctx(
            ctx, [r for r in torch_rules.active_rules()
                  if r.rule_id == "R004"])
        assert [f.rule for f in hits] == ["R004"]



@pytest.mark.parametrize("module,shipped,planted", [
    ("ops/cuda_histogram.py",
     "lib.gbdt_hist_scratch_bytes.restype = ll",
     "lib.gbdt_hist_scratch_bytes.restype = i"),
    ("ops/cuda_encode.py",
     "lib.gbdt_encode_rows.argtypes = [p, ll, i, p, ll, p, d, p, p, p, p]",
     "lib.gbdt_encode_rows.argtypes = [p, ll, i, p, ll, p, i, p, p, p, p]"),
    ("ops/cuda_lambdarank.py",
     "lib.gbdt_lambdarank_tile.restype = i",
     "lib.gbdt_lambdarank_tile.restype = f"),
    ("ops/cuda_walk.py",
     "lib.gbdt_walk_group.argtypes = [i, i, i, i, i]",
     "lib.gbdt_walk_group.argtypes = [i, i, i, ll, i]"),
    ("capi_shim.py",
     "lib.LGBM_GetLastError.restype = ctypes.c_char_p",
     "lib.LGBM_GetLastError.restype = ctypes.c_int")],
    ids=["histogram", "encode", "lambdarank", "walk", "capi_shim"])
def test_r004_checks_each_wrappers_declare(module, shipped, planted):
    """Every wrapper binds its C entries in its own ``declare(lib)``
    (``ops/native.load`` calls it): the shipped bindings match ``csrc/``,
    and a binding planted wrong there fires R004."""
    import importlib
    import inspect
    name = "lightgbm_tpu_torch." + module[:-3].replace("/", ".")
    assert shipped in inspect.getsource(importlib.import_module(name).declare)
    src = os.path.join(REPO, "lightgbm_tpu_torch", module)
    rel = "lightgbm_tpu_torch/" + module
    findings, _ = lint_file(src, rel=rel)
    assert [f for f in findings if f.rule == "R004"] == []
    text = open(src).read()
    assert text.count(shipped) == 1
    ctx = torch_lint._parse_source(src, rel, text.replace(shipped, planted))
    hits = torch_lint._check_ctx(
        ctx, [r for r in torch_rules.active_rules() if r.rule_id == "R004"])
    assert [f.rule for f in hits] == ["R004"]

def test_r001_r005_r009_reach_the_captured_parts_across_modules(tmp_path):
    """A helper in another module, called from a captured part, is
    captured code too; the same helper called from elsewhere is not."""
    pkg = tmp_path / "lightgbm_tpu_torch"
    (pkg / "boosting").mkdir(parents=True)
    (pkg / "boosting" / "gbdt.py").write_text(textwrap.dedent("""\
        import torch
        from ..helpers import bump


        class GBDT:
            def __init__(self):
                self.score = torch.zeros(4)

            def _part_tree(self, k):
                bump(self.score)
        """))
    (pkg / "helpers.py").write_text(textwrap.dedent("""\
        import torch


        def bump(t):
            u = torch.ones(4)
            if u.sum() > 0:
                t.copy_(u)
            u[0] = 0.5


        def unrelated():
            u = torch.ones(4)
            if u.sum() > 0:
                u[0] = 0.5
        """))
    findings, errors = lint_paths([str(pkg)])
    assert errors == []
    got = sorted((os.path.basename(f.path), f.rule, f.line)
                 for f in findings)
    assert got == [("helpers.py", "R001", 6), ("helpers.py", "R009", 8)]


def test_r002_waiver_and_hot_path_scope(tmp_path):
    src = "import torch\n\ndef f(t):\n    x = torch.zeros(2)\n" \
          "    return x.tolist()\n"
    hot = tmp_path / "lightgbm_tpu_torch" / "ops"
    hot.mkdir(parents=True)
    (hot / "m.py").write_text(src)
    cold = tmp_path / "lightgbm_tpu_torch" / "io"
    cold.mkdir(parents=True)
    (cold / "m.py").write_text(src)
    f_hot, _ = lint_file(str(hot / "m.py"),
                         rel="lightgbm_tpu_torch/ops/m.py")
    f_cold, _ = lint_file(str(cold / "m.py"),
                          rel="lightgbm_tpu_torch/io/m.py")
    assert [f.rule for f in f_hot] == ["R002"] and f_cold == []
    # host values are not syncs: shapes, numel, a host list
    (hot / "h.py").write_text(textwrap.dedent("""\
        import torch

        def f(t, xs):
            x = torch.zeros(3)
            n = int(x.shape[0]) + x.numel()
            return float(n), [int(v) for v in xs], len(x)
        """))
    assert lint_file(str(hot / "h.py"),
                     rel="lightgbm_tpu_torch/ops/h.py")[0] == []


def test_r007_sort_outside_the_wave_is_legal_and_small_sorts_waived():
    findings, _ = lint_file(os.path.join(CLEAN, "bad_r007.py"),
                            rel="lightgbm_tpu_torch/bad_r007.py")
    assert findings == []
    g = os.path.join(REPO, "lightgbm_tpu_torch", "grower.py")
    assert "torch-lint: disable=R007" in open(g).read()


# ------------------------------------------------------------ suppression

def test_inline_pragma_suppresses(tmp_path):
    src = "import torch\nBINS = torch.arange(4)  # torch-lint: disable=R006\n"
    p = tmp_path / "lightgbm_tpu_torch" / "mod.py"
    p.parent.mkdir()
    p.write_text(src)
    assert lint_file(str(p), rel="lightgbm_tpu_torch/mod.py")[0] == []
    p.write_text(src.replace("  # torch-lint: disable=R006", ""))
    findings, _ = lint_file(str(p), rel="lightgbm_tpu_torch/mod.py")
    assert [f.rule for f in findings] == ["R006"]
    # the JAX tool's own pragma does not silence this tool
    p.write_text(src.replace("torch-lint", "tpu-lint"))
    findings, _ = lint_file(str(p), rel="lightgbm_tpu_torch/mod.py")
    assert [f.rule for f in findings] == ["R006"]


def test_file_pragma_suppresses(tmp_path):
    p = tmp_path / "mod.py"
    p.write_text("# torch-lint: disable-file=R006\nimport torch\n"
                 "A = torch.arange(4)\nB = torch.zeros(8)\n")
    assert lint_file(str(p), rel="lightgbm_tpu_torch/mod.py")[0] == []


def test_no_hot_module_is_silenced_by_a_file_pragma():
    from lightgbm_tpu_torch.analysis.rules.common import is_hot_path
    seen = 0
    for root, _, files in os.walk(os.path.join(REPO, "lightgbm_tpu_torch")):
        for name in files:
            rel = os.path.relpath(os.path.join(root, name), REPO)
            if name.endswith(".py") and is_hot_path(rel):
                seen += 1
                text = open(os.path.join(root, name)).read()
                assert "torch-lint: disable-file" not in text, rel
    assert seen > 10


def test_baseline_roundtrip_consumption_and_reasons(tmp_path):
    p = tmp_path / "mod.py"
    p.write_text("import torch\nA = torch.arange(4)\n")
    findings, _ = lint_file(str(p), rel="lightgbm_tpu_torch/mod.py")
    assert len(findings) == 1
    bl = Baseline.from_findings(findings)
    key = (findings[0].path, findings[0].rule, findings[0].snippet)
    bl.reasons[key] = "audited"
    path = tmp_path / "baseline.json"
    bl.dump(str(path))
    loaded = Baseline.load(str(path))
    assert loaded.reasons == {key: "audited"}
    assert loaded.suppresses(findings[0])
    dup = Finding(**{**findings[0].__dict__, "line": 99})
    assert not loaded.suppresses(dup)


def test_stale_baseline_entry_fails_and_names_it(tmp_path, capsys,
                                                 monkeypatch):
    pkg = tmp_path / "lightgbm_tpu_torch"
    pkg.mkdir()
    (pkg / "mod.py").write_text("import torch\nA = torch.arange(4)\n")
    monkeypatch.chdir(tmp_path)
    assert main(["lightgbm_tpu_torch", "--update-baseline"]) == 0
    assert main(["lightgbm_tpu_torch"]) == 0
    capsys.readouterr()
    (pkg / "mod.py").write_text("import torch\n\ndef a():\n"
                                "    return torch.arange(4)\n")
    assert main(["lightgbm_tpu_torch"]) == 1
    out = capsys.readouterr().out
    assert "stale baseline entry for R006" in out


def test_exit_codes_and_json(tmp_path, capsys):
    bad = os.path.join(PKG, "bad_r006.py")
    assert main([bad, "--no-baseline", "--select", "R004",
                 "--format", "json"]) == 0
    assert json.loads(capsys.readouterr().out)["findings"] == []
    assert main([bad, "--no-baseline", "--select", "R006"]) == 1
    capsys.readouterr()
    broken = tmp_path / "broken.py"
    broken.write_text("def f(:\n")
    assert main([str(broken), "--no-baseline"]) == 2
    assert main([bad, "--no-baseline", "--select", "R999"]) == 2


def test_sarif_output(capsys):
    rc = main([os.path.join(PKG, "bad_r008.py"), "--no-baseline",
               "--format", "sarif"])
    assert rc == 1
    doc = json.loads(capsys.readouterr().out)
    run = doc["runs"][0]
    assert run["tool"]["driver"]["name"] == "torch-lint"
    assert {r["id"] for r in run["tool"]["driver"]["rules"]} == \
        {f"R{i:03d}" for i in range(1, 14)}
    assert [r["ruleId"] for r in run["results"]] == ["R008", "R008"]


def test_cache_replays_without_reparsing(tmp_path, monkeypatch):
    from lightgbm_tpu_torch.analysis import tpu_lint as tl
    cache = LintCache(str(tmp_path / "c.json"))
    first, _ = lint_paths([PKG], cache=cache)
    calls = []
    orig = tl._parse_source
    monkeypatch.setattr(tl, "_parse_source",
                        lambda *a: calls.append(a) or orig(*a))
    again, _ = lint_paths([PKG], cache=LintCache(str(tmp_path / "c.json")))
    assert [f.format() for f in again] == [f.format() for f in first]
    assert calls == []


def test_the_ports_tree_lints_clean_against_its_baseline():
    """``python -m lightgbm_tpu_torch.analysis lightgbm_tpu_torch/``: exit
    0 against torch_lint_baseline.json, no stale entry; every baseline
    entry carries its reason."""
    out = subprocess.run(
        [sys.executable, "-m", "lightgbm_tpu_torch.analysis",
         "lightgbm_tpu_torch/", "--no-cache"],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "stale" not in out.stdout
    data = json.load(open(os.path.join(REPO, "torch_lint_baseline.json")))
    assert data["findings"] and all(e.get("reason")
                                    for e in data["findings"])


def test_the_linter_imports_no_jax_and_no_torch_at_module_level():
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, importlib.util as u; "
         "spec = u.spec_from_file_location('tl', "
         "'lightgbm_tpu_torch/analysis/tpu_lint.py'); "
         "m = u.module_from_spec(spec); sys.modules['tl'] = m; "
         "spec.loader.exec_module(m); "
         "print(sorted(k for k in sys.modules "
         "if k.split('.')[0] in ('jax', 'torch', 'lightgbm_tpu')))"],
        capture_output=True, text=True, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# ------------------------------------------------- parity with the JAX tool

PARITY_SOURCES = {
    "timing": """\
        import time
        from time import perf_counter as pc

        def a():
            t0 = time.time()
            t1 = pc()
            return time.perf_counter() - t0 + t1, time.monotonic()
        """,
    "handlers": """\
        def a(f):
            try:
                f()
            except Exception:
                pass
            try:
                f()
            except (ValueError, BaseException):
                continue_ = 1
            for _ in range(2):
                try:
                    f()
                except:
                    continue
            try:
                f()
            except OSError:
                pass
        """,
    "threads": """\
        import threading
        from threading import Thread

        class W:
            def start(self):
                self.a = threading.Thread(target=self.run)
                self.a.start()
                self.b = Thread(target=self.run)
                self.b.start()
                self.c = Thread(target=self.run, daemon=True)
                self.c.start()

            def run(self):
                pass

            def close(self):
                self.a.join()

        def pool(n):
            ts = [threading.Thread(target=print) for _ in range(n)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            threading.Thread(target=print).start()
            ", ".join(["x"])
        """,
}
PARITY_RULES = ("R008", "R010", "R012")


def _both(tmp_path, name, src, rule):
    """The (rule, line, col) findings of each tool on one source, placed
    in each tool's own package (its rules' scope)."""
    p = tmp_path / f"{name}.py"
    p.write_text(textwrap.dedent(src))
    out = []
    for lint, rules, pkg in ((jax_lint, jax_rules, "lightgbm_tpu"),
                             (torch_lint, torch_rules, "lightgbm_tpu_torch")):
        chosen = [r for r in rules.active_rules() if r.rule_id == rule]
        findings, err = lint.lint_file(str(p), rel=f"{pkg}/{name}.py",
                                       rules=chosen)
        assert err is None
        out.append([(f.rule, f.line, f.col) for f in findings])
    return out


@pytest.mark.parametrize("rule", PARITY_RULES)
@pytest.mark.parametrize("name", sorted(PARITY_SOURCES))
def test_carried_rules_equal_the_jax_linters(tmp_path, name, rule):
    jax_f, torch_f = _both(tmp_path, name, PARITY_SOURCES[name], rule)
    assert jax_f == torch_f


@pytest.mark.parametrize("relpath,rule", [
    ("bad_r008.py", "R008"), ("bad_r010.py", "R010"),
    ("bad_r012.py", "R012")])
def test_carried_rules_equal_on_the_fixtures(tmp_path, relpath, rule):
    src = open(os.path.join(PKG, relpath)).read()
    jax_f, torch_f = _both(tmp_path, relpath[:-3], src, rule)
    assert jax_f == torch_f and jax_f


def test_engine_parity_pragmas_and_fingerprints(tmp_path):
    """The same source with each tool's pragma: the same suppressions; the
    baseline fingerprints of the same findings are the same keys."""
    body = ("import time\n\ndef a():\n"
            "    x = time.time()  # {tool}: disable=R008\n"
            "    return time.time()\n")
    got = []
    for tool, lint, rules in (("tpu-lint", jax_lint, jax_rules),
                              ("torch-lint", torch_lint, torch_rules)):
        p = tmp_path / f"{tool}.py"
        p.write_text(body.format(tool=tool))
        findings, _ = lint.lint_file(
            str(p), rel="lightgbm_tpu_torch/m.py",
            rules=[r for r in rules.active_rules() if r.rule_id == "R008"])
        got.append([(f.rule, f.line, f.col) for f in findings])
        bl = lint.Baseline.from_findings(findings)
        got.append(sorted(bl.entries.items()))
        path = tmp_path / f"{tool}.json"
        bl.dump(str(path))
        got.append(sorted(json.load(open(path))["findings"][0]))
    assert got[0] == got[3] == [("R008", 5, 12)]
    assert got[1] == got[4]
    assert got[2] == got[5]
    file_pragma = "# {tool}: disable-file=R008\nimport time\nT = time.time()\n"
    for tool, lint, rules in (("tpu-lint", jax_lint, jax_rules),
                              ("torch-lint", torch_lint, torch_rules)):
        p = tmp_path / "fp.py"
        p.write_text(file_pragma.format(tool=tool))
        assert lint.lint_file(str(p), rel="lightgbm_tpu_torch/fp.py")[0] \
            == []


def test_engine_parity_sarif_structure():
    f = dict(rule="R008", path="lightgbm_tpu_torch/m.py", line=3, col=5,
             message="m", snippet="x = time.time()")
    docs = [json.loads(mod.render([lint.Finding(**f)], "tool",
                                  rules=rules.active_rules()))
            for mod, lint, rules in ((jax_sarif, jax_lint, jax_rules),
                                     (torch_sarif, torch_lint, torch_rules))]

    def shape(d):
        if isinstance(d, dict):
            return {k: shape(v) for k, v in d.items()
                    if k not in ("partialFingerprints", "informationUri")}
        if isinstance(d, list):
            return [shape(v) for v in d[:1]]
        return type(d).__name__
    assert shape(docs[0]) == shape(docs[1])
    r0, r1 = docs[0]["runs"][0]["results"][0], docs[1]["runs"][0]["results"][0]
    assert (r0["ruleId"], r0["level"], r0["locations"]) == \
        (r1["ruleId"], r1["level"], r1["locations"])
    assert list(r0["partialFingerprints"].values()) == \
        list(r1["partialFingerprints"].values())
