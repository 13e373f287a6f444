"""Host synchronisations per tree in the profiled batch, eval included:
``analysis.CaptureGuard``'s count (the iteration's flag reads plus the
calls ``torch.cuda.set_sync_debug_mode`` flags) over the batch's trees."""
UNIT = "syncs/tree"
SOURCE = "program_counter"
LAYER = "iteration replay (boosting/gbdt._IterationGraphs)"
MOVES = "train_iter_ms"


def read(ctx):
    r = ctx["record"]
    prof = r.get("profile")
    if r.get("host_syncs") is None or not prof or not prof["iterations"]:
        return None
    return r["host_syncs"] / prof["iterations"]
