"""Program builders and the shipped contract set of the op-trace tier.

Importing this module imports torch and the product modules (which
registers their ``@trace_entry`` hooks), defines one builder per (entry,
shape_class) cell of the matrix and registers the contracts. A builder
records one call of the SHIPPED callable fetched through
:func:`registry.get_entry` — never a local copy — at small shapes on the
CPU: 3,000 rows, 8 features, 15 leaves. The same recording functions take
a booster or a grower on the card (``chip_smoke.py`` phase 22), where B1's
passes are counted by ``ops/cuda_histogram.launch_count()``.

Shape classes:

- ``serial``       the resident grower's waves (one tree), the iteration's
                   parts, the forest walk
- ``nopartition``  the grower without its partition (``tpu_row_compact=
                   false``): each pass's positions come from a stable sort
                   over the rows (``ops/histogram.pass_positions``) — T001's
                   sensitivity pin (expect ``violates``)
- ``stream_shard`` / ``stream_wave``  the streamed wave's per-shard legs,
                   and the rest of the wave (``grower.StreamedGrower``)
- ``data2``        one data-parallel wave in a gloo world of two processes
- ``linear``       the linear-leaf fit of one tree

Contracts carried from the JAX tier (``lightgbm_tpu/analysis/contracts/
entries.py``): T001, T003, T004, T006, T007, T009, T010. Not carried
(ROADMAP "Not queued"): T002 and T008 pin the one-hot MXU contraction the
port drops on purpose (it gathers), T005 pins XLA buffer donation, which
PyTorch does not have (R005 and ``_IterationGraphs.bind`` cover its
hazard).
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

import lightgbm_tpu_torch.boosting.gbdt     # noqa: F401  (registers)
import lightgbm_tpu_torch.grower            # noqa: F401
import lightgbm_tpu_torch.ops.linear        # noqa: F401
import lightgbm_tpu_torch.ops.predict       # noqa: F401

from . import checks as C
from .op_trace import OpTrace, record, unrecorded
from .registry import (Target, TracedProgram, contract, get_entry,
                       program_builder)

N_ROWS, N_FEATURES, N_LEAVES = 3000, 8, 15
# "no sort over rows": an input of at least half the rows; the [L]-sized
# stable sort of the leaf gains stays legal
ROW_SORT_MIN = N_ROWS // 2
BASE_PARAMS = {"objective": "binary", "num_leaves": N_LEAVES, "max_bin": 63,
               "min_data_in_leaf": 5, "verbose": -1, "device": "cpu"}

# the port's deliberate f64, by the site that makes it (ROADMAP C11, C25):
# the split scan's prefix sums; B1's [2] fixed-point scales (made from f64
# maxima, read by the kernel); the root sums' f64 partials, rounded once
# (``grower.py:begin`` stores them); voting's reductions of its votes,
# gains and selected columns (C25); and the kernel, which reads the scales
F64_ALLOW = frozenset({
    "ops/split_finder.py:prefix_sums",
    "ops/histogram.py:histogram_scales",
    "ops/histogram.py:scales_from_max",
    "ops/histogram.py:root_sums_f64",
    "parallel/comm.py:root_sums",
    "parallel/comm.py:histogram_scales",
    "grower.py:begin",
    "parallel/comm.py:find_splits",
    "parallel/comm.py:_reduce_selected",
    "kernel:histogram",
})


def _data(n: int = N_ROWS, f: int = N_FEATURES, seed: int = 0):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, f).astype(np.float32)
    logit = X[:, 0] - 0.5 * X[:, 1] + X[:, 2] * X[:, 3]
    y = (logit + 0.2 * rng.randn(n) > 0.3).astype(np.float32)
    return X, y


def booster(params: Optional[Dict] = None, rounds: int = 1, X=None, y=None):
    """A trained port booster (kept for training) on the CPU harness's
    data."""
    import lightgbm_tpu_torch as lgt
    if X is None:
        X, y = _data()
    p = dict(BASE_PARAMS)
    p.update(params or {})
    return lgt.train(p, lgt.Dataset(X, label=y), num_boost_round=rounds,
                     keep_training_booster=True)


def _flags(grower) -> List[int]:
    with unrecorded():
        return [int(v) for v in grower.state.flags.tolist()]


def record_waves(grower, grad, hess, included, feature_ok,
                 trace: Optional[OpTrace] = None, max_waves: int = 64
                 ) -> OpTrace:
    """One tree's waves of ``grower``, each ``TreeGrower.wave`` (the
    shipped function) recorded; ``begin`` and the flag reads between waves
    (the runner's, outside any captured part) are not. Returns the trace
    with ``waves`` set."""
    wave = get_entry("grower.wave")
    trace = trace if trace is not None else OpTrace()
    grower.begin(grad, hess, included, feature_ok)
    waves = 0
    for _ in range(max_waves):
        with record(trace):
            wave(grower)
        waves += 1
        if _flags(grower)[1]:
            break
    trace.waves = waves
    return trace


def _tree_inputs(gbdt, seed: int = 1):
    g = torch.Generator(device="cpu").manual_seed(seed)
    n = gbdt.num_rows
    dev = gbdt.device
    grad = torch.randn(n, generator=g).to(dev)
    hess = (torch.rand(n, generator=g) * 0.25 + 0.01).to(dev)
    inc = torch.ones(n, device=dev)
    fok = torch.ones(gbdt.spec.num_features, dtype=torch.bool, device=dev)
    return grad, hess, inc, fok


def wave_program(gbdt, shape_class: str) -> TracedProgram:
    """A tree's waves of ``gbdt``'s grower as a program."""
    gbdt._prepare()
    trace = record_waves(gbdt._grower, *_tree_inputs(gbdt))
    return TracedProgram("grower.wave", shape_class, trace,
                         expected_launches=trace.waves)


@program_builder("grower.wave", "serial")
def _wave_serial():
    return wave_program(booster()._gbdt, "serial")


@program_builder("grower.wave", "nopartition")
def _wave_nopartition():
    return wave_program(booster({"tpu_row_compact": False})._gbdt,
                        "nopartition")


# ------------------------------------------------------ the iteration's parts

def record_iteration(gbdt, trace: Optional[OpTrace] = None) -> OpTrace:
    """One eager iteration of ``gbdt`` with exactly what the CUDA graphs
    capture recorded: the parts (``GBDT._part_start``, per model
    ``_part_tree``, the waves, ``_part_tree_end``), the shipped methods;
    the batch inputs' copy in and the flag reads between waves (the
    runner's) are not. The booster must have run an iteration (its stacked
    tree buffers exist, as before any capture)."""
    start = get_entry("boosting.part_start")
    tree = get_entry("boosting.part_tree")
    end = get_entry("boosting.part_tree_end")
    wave = get_entry("grower.wave")
    trace = trace if trace is not None else OpTrace()
    gbdt._prepare()
    it = gbdt.iter_
    tab_i, tab_f = gbdt._batch_inputs([it], gbdt._step_shrinkage())
    gbdt._in_i.copy_(tab_i[0])
    gbdt._in_f.copy_(tab_f[0])
    with record(trace):
        start(gbdt, it)
    waves = 0
    for k in range(gbdt.num_models):
        with record(trace):
            tree(gbdt, k)
        while True:
            with record(trace):
                wave(gbdt._grower)
            waves += 1
            if _flags(gbdt._grower)[1]:
                break
        with record(trace):
            end(gbdt, k)
    trace.waves = waves
    return trace


@program_builder("boosting.iteration", "serial")
def _iteration_serial():
    gbdt = booster({"bagging_fraction": 0.8, "bagging_freq": 1,
                    "feature_fraction": 0.8})._gbdt
    trace = record_iteration(gbdt)
    return TracedProgram("boosting.iteration", "serial", trace,
                         expected_launches=trace.waves)


# --------------------------------------------------------- the streamed legs

def _streamed_grower():
    gbdt = booster({"tpu_residency": "stream",
                    "tpu_stream_shard_rows": 1024})._gbdt
    gbdt._prepare()
    g = gbdt._grower
    g.begin(*_tree_inputs(gbdt))
    return gbdt, g


@program_builder("grower.stream_legs", "stream_shard")
def _stream_shard():
    """One pass of the per-shard legs (route by the pending table, add the
    pending rows into the carried accumulator) over every shard."""
    gbdt, g = _streamed_grower()
    slot_of_leaf, _ = g._slots(g.state.flags[1] == 0)
    g.acc.zero_()
    with record() as trace:
        get_entry("grower.stream_legs")._shard_pass(g, slot_of_leaf)
    return TracedProgram("grower.stream_legs", "stream_shard", trace)


@program_builder("grower.stream_legs", "stream_wave")
def _stream_wave():
    """One streamed wave without its shard legs (their cell above): the
    accumulator's conversion, the split scan and apply, the flags."""
    gbdt, g = _streamed_grower()
    cls = get_entry("grower.stream_legs")
    legs = cls._shard_pass

    def quiet(self, slot_of_leaf):
        with unrecorded():
            return legs(self, slot_of_leaf)
    g._shard_pass = quiet.__get__(g)
    try:
        with record() as trace:
            cls.wave(g)
    finally:
        del g._shard_pass
    return TracedProgram("grower.stream_legs", "stream_wave", trace)


# ------------------------------------------------------------- linear fit

def record_linear_fit(gbdt, trace: Optional[OpTrace] = None) -> OpTrace:
    """The linear fit of one tree grown by ``gbdt``'s grower
    (``ops/linear.fit_linear_leaves``, the shipped function)."""
    fit = get_entry("linear.fit")
    gbdt._prepare()
    grower = gbdt._grower
    grad, hess, inc, fok = _tree_inputs(gbdt)
    tree, leaf_ids = grower.grow(grad, hess, inc, fok)
    trace = trace if trace is not None else OpTrace()
    with record(trace):
        fit(tree, *gbdt.raw, leaf_ids, grower.grad, grower.hess,
            grower.included, gbdt.is_cat,
            max_features=gbdt.config.linear_max_features,
            linear_lambda=gbdt.config.linear_lambda)
    return trace


@program_builder("linear.fit", "linear")
def _linear_fit():
    X, y = _data()
    gbdt = booster({"linear_tree": True, "objective": "regression"},
                   X=X, y=X[:, 0] * 2.0 + y)._gbdt
    return TracedProgram("linear.fit", "linear", record_linear_fit(gbdt))


# ------------------------------------------------------------ forest walk

def record_walk(bst, X: np.ndarray, device=None,
                trace: Optional[OpTrace] = None) -> OpTrace:
    """``ops/predict.forest_walk_leaves`` (the shipped function) over
    ``bst``'s forest on ``X``'s encoded rows, on ``device``."""
    from lightgbm_tpu_torch.ops.predict import StackedForest
    walk = get_entry("predict.forest_walk")
    bst._ensure_finalized()
    forest = StackedForest(bst.trees, X.shape[1])
    dev = torch.device(device or "cpu")
    arrays = forest.to(dev)
    codes, is_nan, is_zero = (torch.as_tensor(a).to(dev)
                              for a in forest.encode_rows(X))
    trace = trace if trace is not None else OpTrace()
    with record(trace):
        walk(*arrays, codes, is_nan, is_zero, forest.max_depth)
    return trace


@program_builder("predict.forest_walk", "serial")
def _walk_serial():
    X, _ = _data()
    bst = booster(rounds=3)
    return TracedProgram("predict.forest_walk", "serial",
                         record_walk(bst, X[:500]))


# ------------------------------------------------ data-parallel, a world of 2

def data_parallel_wave(machines: str, port: int, world: int) -> Dict:
    """One rank's data-parallel wave recorded (run in each rank of a gloo
    world): the collectives counted by kind at the
    ``parallel/comm.Collectives`` surface over one tree's waves, and what
    ``collective_bytes()`` charges per wave."""
    from lightgbm_tpu_torch.parallel import comm as comm_mod
    net = dict(machines=machines, num_machines=world,
               local_listen_port=port, time_out=1, tree_learner="data")
    gbdt = booster(net)._gbdt
    gbdt._prepare()
    counts = {"all_reduce": 0, "all_gather": 0, "reduce_scatter": 0}
    saved = {k: getattr(comm_mod.Collectives, k) for k in counts}

    def counting(kind):
        def wrapper(self, *a, **kw):
            counts[kind] += 1
            return saved[kind](self, *a, **kw)
        return wrapper
    for k in counts:
        setattr(comm_mod.Collectives, k, counting(k))
    try:
        trace = record_waves(gbdt._grower, *_tree_inputs(gbdt))
    finally:
        for k, fn in saved.items():
            setattr(comm_mod.Collectives, k, fn)
    spec = gbdt.spec
    charged = gbdt.comm.collective_bytes(
        spec.hist_slots, spec.num_bins_padded,
        use_categorical=spec.use_categorical,
        hist_bins=spec.hist_bins or None)
    return {"collectives": counts, "comm": charged, "waves": trace.waves,
            "kernel_passes": trace.kernel_passes,
            "strategy": gbdt.pctx.strategy}


def _free_ports(n: int) -> List[int]:
    socks, ports = [], []
    try:
        for _ in range(n):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.bind(("127.0.0.1", 0))
            socks.append(s)
            ports.append(s.getsockname()[1])
    finally:
        for s in socks:
            s.close()
    return ports


WORLD_DEADLINE_S = 180


@program_builder("grower.wave", "data2")
def _wave_data2():
    """Rank 0's program of a two-process gloo world on this machine, each
    rank ``python -m lightgbm_tpu_torch.analysis.contracts.entries``."""
    ports = _free_ports(2)
    machines = ",".join(f"127.0.0.1:{p}" for p in ports)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1")
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for r in range(2):
            out = os.path.join(tmp, f"rank{r}.json")
            procs.append((subprocess.Popen(
                [sys.executable, "-m",
                 "lightgbm_tpu_torch.analysis.contracts.entries",
                 machines, str(ports[r]), "2", out],
                env=env, stdout=subprocess.DEVNULL,
                stderr=subprocess.PIPE, start_new_session=True), out))
        t_end = time.monotonic() + WORLD_DEADLINE_S
        try:
            while any(p.poll() is None for p, _ in procs):
                if time.monotonic() > t_end:
                    raise TimeoutError("data2: the world of two passed its "
                                       f"{WORLD_DEADLINE_S} s deadline")
                time.sleep(0.05)
        finally:
            for p, _ in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        bad = [(p.returncode, p.stderr.read().decode()[-2000:])
               for p, _ in procs if p.returncode != 0]
        if bad:
            raise RuntimeError(f"data2: a rank failed: {bad}")
        res = [json.load(open(out)) for _, out in procs]
    return program_from_rank(res[0], "data2")


def program_from_rank(res: Dict, shape_class: str) -> TracedProgram:
    """The program of one rank's :func:`data_parallel_wave` result."""
    return TracedProgram("grower.wave", shape_class, OpTrace(),
                         comm=res["comm"], collectives=res["collectives"],
                         notes=res["strategy"])


# --------------------------------------------------------------- contracts

contract(
    "T001", "no sort over rows in the resident wave", "grower.wave",
    checks=[C.ForbidOps({"sort", "argsort", "unique", "_unique2",
                         "unique_consecutive"}, min_numel=ROW_SORT_MIN)],
    targets=[Target("serial"), Target("nopartition", "violates")],
    doc="The incremental partition keeps the rows leaf-contiguous with "
        "counts and prefix sums; a pass without it derives its positions "
        "with a stable sort over the rows (ops/histogram.pass_positions), "
        "the pin that keeps this check sensitive.")

contract(
    "T003", "data-parallel collectives match collective_bytes()",
    "grower.wave",
    checks=[C.RequiredCollectives()],
    targets=[Target("data2")],
    doc="Every collective the cost model charges runs, and none it does "
        "not charge runs.")

contract(
    "T004", "no f64 in the wave outside the allowlist", "grower.wave",
    checks=[C.DtypeDiscipline(F64_ALLOW)],
    targets=[Target("serial"), Target("nopartition")],
    doc="f64 belongs to the split scan's prefix sums (C11), B1's scales "
        "and the root sums' partials (and voting's reductions, C25).")

contract(
    "T006", "the captured parts read nothing on the host",
    "boosting.iteration",
    checks=[C.NoHostTransfer(), C.DtypeDiscipline(F64_ALLOW),
            C.CountKernelLaunches()],
    targets=[Target("serial")],
    doc="Every part _IterationGraphs captures (start, tree, waves, end) "
        "runs on the card alone; one B1 pass per wave.")

contract(
    "T007", "the streamed legs stay sort-free and on the device",
    "grower.stream_legs",
    checks=[C.ForbidOps({"sort", "argsort"}, min_numel=ROW_SORT_MIN // 4),
            C.NoHostTransfer(), C.DtypeDiscipline(F64_ALLOW)],
    targets=[Target("stream_shard"), Target("stream_wave")],
    doc="Each shard step sorts its rows to slot-grouped positions today "
        "(ops/cuda_histogram.py HistogramAccumulator.add through "
        "pass_positions): baselined until ROADMAP A14b builds them with a "
        "count and a prefix sum.")

contract(
    "T009", "one batched Cholesky per linear fit", "linear.fit",
    checks=[C.CountOp("linalg_cholesky_ex", 1)],
    targets=[Target("linear")],
    doc="Every leaf solves in one batched factorization "
        "(ops/linear.py solve_leaf_models).")

contract(
    "T010", "the forest walk is sort-free and host-clean",
    "predict.forest_walk",
    checks=[C.ForbidOps({"sort", "argsort"}), C.NoHostTransfer(),
            C.DtypeDiscipline()],
    targets=[Target("serial")])


def _main(argv: List[str]) -> int:
    """A rank of :func:`_wave_data2`'s world: ``machines port world
    out.json``."""
    torch.set_num_threads(1)
    machines, port, world, out = argv
    res = data_parallel_wave(machines, int(port), int(world))
    with open(out, "w") as fh:
        json.dump(res, fh)
    return 0


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
