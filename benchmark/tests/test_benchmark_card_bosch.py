"""On the card, at ``bosch.train``'s own size: the program is correct on
three seeds, trains every tree of them in bundle space, and the control
(the reference in the precision below the configuration's) and each
planted fault fail one of the cell's numbers on the same seeds. The limits
in ``benchmark/limits/bosch.train.json`` were set from the same readings on
other seeds (``PERF.md``). Run it from the root of a checkout on a machine
with the card:

    python3 -m pytest benchmark/tests -m card -s
"""
import time

import pytest

from benchmark.tests.test_benchmark_card import SEEDS

CELL = "bosch.train"


@pytest.mark.card
def test_bosch_control_fails_and_program_passes_at_full_size(card):
    from benchmark.harness import manifest
    from benchmark.harness.report import run_cell
    from lightgbm_tpu_torch import observability as obs
    seconds = manifest.load_manifest()["run_seconds"]
    features = int(manifest.config("bosch")["data"]["features"])
    for seed in SEEDS:
        obs.reset_for_tests()
        res = run_cell(CELL, seed, seconds, False, card, time.perf_counter(),
                       control=True)
        gauges = obs.get_registry().snapshot()["gauges"]
        print(CELL, seed, {k: c["value"] for k, c in res["checks"].items()},
              res["control"], {k: v for k, v in gauges.items()
                               if k.startswith("efb.")}, flush=True)
        assert res["correct"] is True
        assert gauges["efb.features"] == features
        assert gauges["efb.bundles"] <= features // 2
        checks = res["checks"]
        for name, readings in res["control"].items():
            if name == "reference_f64":
                assert all(readings.get(k, 0) <= c["limit"]
                           for k, c in checks.items())
                continue
            assert any(readings.get(k, 0) > c["limit"]
                       for k, c in checks.items()), (name, readings)
