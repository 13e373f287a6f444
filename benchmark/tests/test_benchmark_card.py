"""On the card, at each cell's own size: the program is correct on three
seeds, and the control (the reference in the precision below the
configuration's) and, for training, each planted fault fail one of the
cell's numbers on the same seeds. The limits in ``benchmark/limits/`` were
set from the same readings on other seeds (``PERF.md``). Run it from the
root of a checkout on a machine with the card:

    python3 -m pytest benchmark/tests -m card -s
"""
import time

import pytest

SEEDS = (2147483659, 3000000019, 4100000037)


@pytest.mark.card
@pytest.mark.parametrize("cell", ["higgs.train", "mslr.train",
                                  "higgs.score"])
def test_control_fails_and_program_passes_at_full_size(cell, card):
    from benchmark.harness import manifest
    from benchmark.harness.report import run_cell
    seconds = manifest.load_manifest()["run_seconds"]
    for seed in SEEDS:
        res = run_cell(cell, seed, seconds, False, card, time.perf_counter(),
                       control=True)
        print(cell, seed, {k: c["value"] for k, c in res["checks"].items()},
              res["control"], flush=True)
        assert res["correct"] is True
        checks = res["checks"]
        for name, readings in res["control"].items():
            if name == "reference_f64":
                assert all(readings.get(k, 0) <= c["limit"]
                           for k, c in checks.items())
                continue
            assert any(readings.get(k, 0) > c["limit"]
                       for k, c in checks.items()), (name, readings)
