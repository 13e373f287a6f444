"""The run's refusals: a JAX module by whole top-level name, a port from
outside the checkout, a CPU-only box; and what a run on the CPU gives."""
import os
import subprocess
import sys
import types

import pytest

from benchmark.harness import env
from benchmark.tests.conftest import ROOT, run_tiny

CONTRACT_KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def test_forbidden_modules_compare_whole_top_level_names():
    assert env.forbidden_modules(["lightgbm_tpu", "lightgbm_tpu.ops.x",
                                  "jax", "jax.numpy", "jaxlib.xla", "flax"]
                                 ) == ["flax", "jax", "jax.numpy",
                                       "jaxlib.xla", "lightgbm_tpu",
                                       "lightgbm_tpu.ops.x"]
    assert env.forbidden_modules(["lightgbm_tpu_torch",
                                  "lightgbm_tpu_torch.ops", "jaxtyping",
                                  "flaxen", "numpy"]) == []


def test_a_planted_import_is_found(monkeypatch):
    import lightgbm_tpu_torch  # noqa: F401
    assert env.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "lightgbm_tpu",
                        types.ModuleType("lightgbm_tpu"))
    assert "lightgbm_tpu" in env.forbidden_modules()


def test_a_port_outside_the_checkout_is_refused(tmp_path):
    (tmp_path / "benchmark").mkdir()
    with pytest.raises(env.RunRefused):
        env.use_checkout_package(str(tmp_path))


def _cli(args, cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_the_command_refuses_a_box_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would measure")
    proc = _cli(["--workload", "higgs.train", "--seed", "4294967296",
                 "--seconds", "1", "--trace", "0"], ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "cuda" in proc.stderr.lower()


def test_the_command_refuses_a_directory_of_only_its_files(tmp_path):
    """A directory holding only BENCHMARK.json and the files under
    ``paths``: no port, no result."""
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark")
    proc = _cli(["--workload", "higgs.train", "--seed", "1", "--seconds",
                 "1", "--trace", "0"], str(tmp_path))
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


@pytest.mark.parametrize("trace", [False, True])
def test_a_cpu_run_has_the_contract_keys_and_no_device_numbers(trace):
    """At a tiny size on the CPU the harness gives a result of the
    contract's keys; its platform says ``cpu`` (the command never prints
    it), and the per-layer metrics read from the device trace are absent,
    since no operation ran on a device."""
    res = run_tiny("higgs.train", trace=trace)
    assert CONTRACT_KEYS <= set(res)
    assert list(res)[-1] == "checks"
    assert res["device"]["platform"] == "cpu"
    assert res["correct"] is True
    if trace:
        for name in ("b1_roofline_pct", "device_idle_pct.train",
                     "step_mfu.train"):
            assert name not in res["metrics"]
        assert res["device"]["busy_s"] == 0.0
    else:
        assert set(res["metrics"]) == {"train_iter_ms", "setup_s"}
