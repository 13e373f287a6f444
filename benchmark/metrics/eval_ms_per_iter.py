"""Milliseconds of metric evaluation per iteration of the window: the
program's ``eval`` spans recorded inside the window, over the window's
iterations."""
UNIT = "ms"
SOURCE = "program_span"
LAYER = "engine and metrics (engine.py, metrics.py)"
MOVES = "train_iter_ms"


def read(ctx):
    r = ctx["record"]
    if r.get("eval_s") is None or not r.get("iterations"):
        return None
    return r["eval_s"] / r["iterations"] * 1e3
