"""The benchmark of ``lightgbm_tpu_torch`` on one CUDA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout. See ``benchmark/README.md``.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    from benchmark.harness import env
    env.set_cache_dirs(ROOT)
    from benchmark.harness.report import main
    sys.exit(main(t_start=T_START))
