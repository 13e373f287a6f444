"""Seconds of ``Dataset.construct`` of the training and the valid set: bin
finding, binning and placement (host clock around both calls)."""
UNIT = "s"
SOURCE = "host_clock"
LAYER = "dataset and binning (dataset.py, binning.py, ops/ingest.py)"
MOVES = "setup_s"


def read(ctx):
    return ctx["record"].get("construct_s")
