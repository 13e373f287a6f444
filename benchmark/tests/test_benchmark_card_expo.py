"""On the card, at ``expo.train``'s own size: the program is correct on
three seeds, every checked tree holds categorical splits, and the control
(the reference in the precision below the configuration's) and each
planted fault fail one of the cell's numbers on the same seeds. The limits
in ``benchmark/limits/expo.train.json`` were set from the same readings on
other seeds (``PERF.md``). Run it from the root of a checkout on a machine
with the card:

    python3 -m pytest benchmark/tests -m card -s
"""
import time

import pytest

from benchmark.tests.test_benchmark_card import SEEDS

CELL = "expo.train"


@pytest.mark.card
def test_expo_control_fails_and_program_passes_at_full_size(card):
    from benchmark.harness import manifest
    from benchmark.harness.report import run_cell
    from lightgbm_tpu_torch import observability as obs
    seconds = manifest.load_manifest()["run_seconds"]
    data = manifest.config("expo")["data"]
    for seed in SEEDS:
        obs.reset_for_tests()
        res = run_cell(CELL, seed, seconds, False, card, time.perf_counter(),
                       control=True)
        gauges = obs.get_registry().snapshot()["gauges"]
        detail = res["detail"]["judge_detail"]
        print(CELL, seed, {k: c["value"] for k, c in res["checks"].items()},
              res["control"], [d["cat_nodes"] for d in detail],
              {k: v for k, v in gauges.items()
               if k.startswith("categorical.")}, flush=True)
        assert res["correct"] is True
        assert gauges["categorical.features"] == len(data["categorical"])
        assert all(d["cat_nodes"] > 0 for d in detail)
        checks = res["checks"]
        for name, readings in res["control"].items():
            if name == "reference_f64":
                assert all(readings.get(k, 0) <= c["limit"]
                           for k, c in checks.items())
                continue
            assert any(readings.get(k, 0) > c["limit"]
                       for k, c in checks.items()), (name, readings)
