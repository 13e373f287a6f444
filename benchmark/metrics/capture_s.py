"""Seconds the booster's iteration took to capture into CUDA graphs and
instantiate them: ``_IterationGraphs.capture_s + instantiate_s``, the
program's own counters. Nothing where the iteration was not captured."""
UNIT = "s"
SOURCE = "program_counter"
LAYER = "iteration replay (boosting/gbdt._IterationGraphs)"
MOVES = "setup_s"


def read(ctx):
    return ctx["record"].get("capture_s")
