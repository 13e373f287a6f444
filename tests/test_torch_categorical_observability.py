"""The categorical path's spans and registry entries in the PyTorch port:
the ``categorical.*`` gauges a categorical booster sets once, the
``tree.cat_splits`` counter beside ``tree.leaves``, the ``categorical``
attribute of ``construct.bin``, and, on the card, the categorical scan's
timing events in the captured wave graph: present only where spans were
recorded at capture, read into ``iteration.device_ms.cat_scan``
(docs/Observability-torch.md). A numerical booster records none of them."""
import ctypes

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import observability as obs

torch.set_num_threads(1)

PARAMS = dict(objective="binary", num_leaves=15, min_data_in_leaf=5,
              min_sum_hessian_in_leaf=1.0, min_data_per_group=20,
              verbose=-1, metric="none")
GAUGES = ("categorical.features", "categorical.max_bins",
          "categorical.code_bytes")
# CUgraphNodeType (cuda.h)
EVENT_RECORD = 7


def _rows(n=3000, seed=3):
    """Two categorical columns (40 and 9 categories, ids from 1) whose
    categories carry the label, and a numerical one."""
    rng = np.random.RandomState(seed)
    a = rng.randint(1, 41, n)
    b = rng.randint(1, 10, n)
    x = rng.rand(n)
    logit = np.where(a % 3 == 0, 1.5, -1.0) + np.where(b > 6, 1.0, 0.0) + x
    y = (rng.rand(n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    return np.column_stack([a, b, x]).astype(np.float32), y


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: this test runs on the chip")
    return torch.device("cuda", 0)


@pytest.fixture
def recorded():
    obs.reset_for_tests()
    obs.configure(enabled=True)
    yield obs
    obs.reset_for_tests()


def _cat_splits(bst) -> int:
    return sum(int((np.asarray(t.decision_type) & 1).sum())
               for t in bst.trees)


def _train(X, y, device="cpu", categorical=(0, 1), rounds=4, **more):
    train = lgt.Dataset(X[:2500], label=y[:2500],
                        categorical_feature=list(categorical))
    valid = lgt.Dataset(X[2500:], label=y[2500:], reference=train)
    return lgt.train(dict(PARAMS, device=device, **more), train,
                     num_boost_round=rounds, valid_sets=[valid],
                     keep_training_booster=True)


def test_a_categorical_run_records_its_gauges_and_splits(recorded):
    X, y = _rows()
    bst = _train(X, y)
    g = bst._gbdt
    snap = obs.get_registry().snapshot()
    assert {k: snap["gauges"][k] for k in GAUGES} == {
        "categorical.features": 2, "categorical.max_bins": 40,
        "categorical.code_bytes": g.Xb.element_size()}
    assert _cat_splits(bst) > 0
    assert snap["counters"]["tree.cat_splits"] == _cat_splits(bst)
    # the valid set's binning marks its categorical columns
    args = [e["args"] for e in obs.get_tracer().events()
            if e["name"] == "construct.bin" and e["ph"] == "X"]
    assert {"rows": 500, "categorical": 2} in args


def test_a_numerical_run_records_none_of_them(recorded):
    X, y = _rows()
    _train(X, y, categorical=())
    snap = obs.get_registry().snapshot()
    assert not [k for k in snap["gauges"] if k.startswith("categorical.")]
    assert "tree.cat_splits" not in snap["counters"]
    assert "iteration.device_ms.cat_scan" not in snap["histograms"]
    assert all("categorical" not in e.get("args", {})
               for e in obs.get_tracer().events()
               if e["name"] == "construct.bin")


def _node_types(graph: torch.cuda.CUDAGraph):
    """The types of a kept graph's nodes (``cuGraphGetNodes``)."""
    lib = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert lib.cuGraphGetNodes(handle, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert lib.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) == 0
    out = []
    for node in nodes:
        t = ctypes.c_int(-1)
        assert lib.cuGraphNodeGetType(ctypes.c_void_p(node),
                                      ctypes.byref(t)) == 0
        out.append(t.value)
    return out


def _captured_node_types(trace: bool, categorical=(0, 1)):
    """Each captured graph's node types, of a run with spans recorded or
    not at capture (the graphs kept: see the test)."""
    obs.reset_for_tests()
    obs.configure(enabled=trace)
    X, y = _rows()
    bst = _train(X, y, device="cuda", categorical=categorical, rounds=12,
                 tree_batch=4, tpu_wave_size=2, tpu_hist_slots=2)
    graphs = bst._gbdt._graphs
    assert graphs is not None and "wave" in graphs.graphs
    return {key: _node_types(g) for key, g in graphs.graphs.items()}, \
        obs.get_registry().snapshot(), graphs


@pytest.mark.card
def test_only_a_traced_categorical_capture_holds_event_nodes(card,
                                                             monkeypatch):
    kept = torch.cuda.CUDAGraph
    monkeypatch.setattr(torch.cuda, "CUDAGraph",
                        lambda keep_graph=False: kept(keep_graph=True))
    try:
        off, _, _ = _captured_node_types(trace=False)
        on, snap, graphs = _captured_node_types(trace=True)
        numerical, num_snap, _ = _captured_node_types(trace=True,
                                                      categorical=())
    finally:
        obs.reset_for_tests()
    assert set(off) == set(on)
    for key in off:
        assert EVENT_RECORD not in off[key], key
        extra = 2 if key == "wave" else 0
        assert len(on[key]) == len(off[key]) + extra, key
        assert on[key].count(EVENT_RECORD) == extra, key
    assert all(EVENT_RECORD not in types for types in numerical.values())
    scan = snap["histograms"]["iteration.device_ms.cat_scan"]
    assert scan["count"] == snap["counters"]["iteration.timed"] > 0
    assert scan["sum"] > 0
    # waves of two splits: a timed tree runs several waves, each read
    # through a pair of events of its own
    assert graphs.scan_timer.armed > 2 * scan["count"]
    assert len(graphs.scan_timer.pairs) > 2
    assert "iteration.device_ms.cat_scan" not in num_snap["histograms"]
