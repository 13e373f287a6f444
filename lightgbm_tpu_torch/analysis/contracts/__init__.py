"""Op-trace contracts: declarative predicates over the aten operations the
port's shipped entry points dispatch (the port of
``lightgbm_tpu/analysis/contracts/``).

This package front door stays importable WITHOUT torch: product modules
(``grower.py``, ``ops/linear.py``, ``ops/predict.py``,
``boosting/gbdt.py``) import :func:`trace_entry` from here at import time.
Only ``entries.py`` (the program builders) and ``op_trace.py`` (the
recorder) use torch, when the trace tier runs (``python -m
lightgbm_tpu_torch.analysis --trace`` / the tests / ``chip_smoke.py``).
"""
from .registry import (  # noqa: F401
    CONTRACTS,
    Contract,
    ENTRY_POINTS,
    PROGRAM_BUILDERS,
    Target,
    TracedProgram,
    build_program,
    contract,
    evaluate,
    evaluate_target,
    get_entry,
    program_builder,
    trace_entry,
)
