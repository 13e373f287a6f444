"""The distributed learners of ``lightgbm_tpu_torch`` (``parallel/comm.py``,
the row layout of ``boosting/gbdt.py``, the grower's integer reduction) on
gloo worlds of CPU processes, against the JAX package.

Ranks are subprocesses on 127.0.0.1 (``_torch_world.run_world``) running
the scripts held below as strings; each sets ``torch.set_num_threads(1)``
and imports neither JAX nor ``lightgbm_tpu`` (checked in every rank's
``sys.modules``). The JAX oracle is the JAX package in this process with
``num_machines=2`` or ``4`` on the conftest's virtual CPU devices (its
single-process path, ``parallel/comm.py:1249-1251`` there), on the same
seeded data. The bars:

- model text byte-equal to the JAX package's at worlds 2 and 4 for
  ``tree_learner=data|feature|voting`` on exact-arithmetic gradients
  (``_exact_fobj``), with bagging and feature_fraction; the bundled data
  and feature learners on an EFB input; GOSS under ``data``;
- the port's data- and feature-parallel text byte-equal to its serial text
  on arbitrary floats (binary objective): the histogram sums are reduced
  as B1's int64 fixed-point sums at the world's scale (ROADMAP C25);
- the categorical learners at worlds 2 and 4 (one categorical column,
  which one rank's feature block holds) equal to the JAX package's text;
- each comm class's reduction and ``find_splits`` at world 2 equal to the
  JAX class's under ``shard_map``, on the same seeded inputs: the data
  comms reduce B1's integer sums (``reduce_sums``) from the ranks' rows;
- the host-side copies (``choose_tree_learner``, ``parse_machine_list``,
  ``_local_rank``, ``robustness/retry.py``) equal to the JAX package's on
  its own tables, and ``host_allgather``'s exchange and timeout.

Alone this file takes about 80 s on the CPU (CHANGES.md).
"""
import datetime
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.grower import GrowerSpec as JaxSpec
from lightgbm_tpu.parallel import comm as jcomm
from lightgbm_tpu_torch.grower import GrowerSpec
from lightgbm_tpu_torch.parallel import comm as tcomm
from lightgbm_tpu_torch.robustness import retry as tretry

from _torch_world import run_world

torch.set_num_threads(1)

# ------------------------------------------------------------ rank scripts

TRAIN_SCRIPT = r'''
import json, sys, time
import numpy as np, torch
torch.set_num_threads(1)
spec = json.load(open(sys.argv[1])); rank = int(sys.argv[2])
import lightgbm_tpu_torch as lgt

def exact_fobj(preds, ds):
    y = ds.get_label()
    g = np.clip(np.round((preds - y) * 64) / 64.0, -2.0, 2.0)
    return g, np.ones_like(g)

net = dict(machines=spec["machines"], num_machines=spec["world"],
           local_listen_port=spec["ports"][rank], time_out=1,
           device="cpu", verbose=-1)
out = {"texts": {}, "bundled": {}, "strategy": {}}
for case in spec["cases"]:
    d = np.load(case["data"])
    b = lgt.train(dict(case["params"], **net),
                  lgt.Dataset(d["X"], label=d["y"]),
                  num_boost_round=case["rounds"],
                  fobj=exact_fobj if case["fobj"] else None,
                  keep_training_booster=True)
    out["texts"][case["name"]] = b.model_to_string()
    out["bundled"][case["name"]] = b._gbdt.bundle is not None
    out["strategy"][case["name"]] = b._gbdt.pctx.strategy
out["modules"] = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "lightgbm_tpu"))
json.dump(out, open(spec["out"].format(rank=rank), "w"))
'''

COMM_SCRIPT = r'''
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
spec = json.load(open(sys.argv[1])); rank = int(sys.argv[2])
import torch.distributed as dist
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.grower import GrowerSpec
from lightgbm_tpu_torch.ops.cuda_histogram import (HistogramAccumulator,
                                                   build_histograms_cuda)
from lightgbm_tpu_torch.parallel import comm
cfg = lgt.Config.from_params(dict(
    machines=spec["machines"], num_machines=spec["world"],
    local_listen_port=spec["ports"][rank], time_out=1, device="cpu"))
assert comm.init_distributed(cfg)
d = np.load(spec["data"])
t = {k: torch.as_tensor(d[k]) for k in d.files}
S, F, B = t["pg"].shape[0], t["nb"].shape[0], t["local"].shape[3]
gspec = GrowerSpec(**spec["spec"])
out = {"modules": sorted(m for m in sys.modules
                         if m.split(".")[0] in ("jax", "lightgbm_tpu"))}
from lightgbm_tpu_torch.grower import BundleDecode
e = np.load(spec["efb"])
te = {k: torch.as_tensor(e[k]) for k in e.files}
bundle = BundleDecode(*[te[k].int() for k in BundleDecode._fields])
bspec = GrowerSpec(**spec["efb_spec"])
for kind in ("data", "feature", "voting", "data_efb", "feature_efb"):
    d_, sp, bun = (te, bspec, bundle) if kind.endswith("_efb") else \
        (t, gspec, None)
    Fk = d_["nb"].shape[0]
    Fh, Bh = d_["local"].shape[2], d_["local"].shape[3]
    ctx = comm.ParallelContext(kind.split("_")[0], dist.group.WORLD, rank,
                               spec["world"], torch.device("cpu"), top_k=2)
    c = ctx.make_comm(Fk, num_data=d_["rows_g"].shape[0],
                      num_bundles=Fh if bun is not None else 0,
                      bundle_col=None if bun is None else bun.col)
    if c.reduces_sums:
        # this rank's rows through B1's plain version into an integer
        # accumulator, reduced over the ranks, converted once
        mine = d_["rows_owner"] == rank
        g = d_["rows_g"][mine].float()
        h = torch.ones_like(g)
        scales = c.histogram_scales(g, h)
        acc = HistogramAccumulator(S, Fh, Bh, torch.device("cpu"))
        blk = HistogramAccumulator(S, Fh // spec["world"], Bh,
                                   torch.device("cpu"))
        build_histograms_cuda(d_["rows_X"][mine], g, h, torch.ones_like(g),
                              d_["rows_slot"][mine].int(),
                              torch.arange(S, dtype=torch.int32), S, Bh,
                              scales=scales, acc=acc)
        red = c.reduce_sums(acc, blk).finalize(scales)
    elif kind.startswith("feature"):
        Fb = Fh // spec["world"]
        red = c.reduce_hist(
            d_["global"][:, rank * Fb:(rank + 1) * Fb].contiguous())
    else:
        red = c.reduce_hist(d_["local"][rank])
    bm = c.block_meta(d_["fok"], d_["nb"], d_["mc"], d_["db"], d_["ic"])
    cand = c.find_splits(red, d_["pg"], d_["ph"], d_["pc"], bm, sp,
                         None if bun is None else c.localize_bundle(bun))
    out[kind] = {"red": red.tolist(),
                 "cand": {f: v.tolist() for f, v in cand._asdict().items()},
                 "bytes": c.collective_bytes(S, B, use_categorical=False)}
json.dump(out, open(spec["out"].format(rank=rank), "w"))
'''


GATHER_SCRIPT = r'''
import json, sys
import torch
torch.set_num_threads(1)
spec = json.load(open(sys.argv[1])); rank = int(sys.argv[2])
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.parallel import comm
cfg = lgt.Config.from_params(dict(
    machines=spec["machines"], num_machines=spec["world"],
    local_listen_port=spec["ports"][rank], time_out=1, device="cpu"))
assert comm.init_distributed(cfg)
store = comm.distributed_store()
out = {"got": [], "seqs": [], "own_keys_left": []}
for _ in range(2):
    seq = comm._host_allgather_seq[0]
    out["got"].append(comm.host_allgather({"rank": rank, "x": [rank] * 3},
                                          "t", timeout_ms=20_000))
    out["seqs"].append(seq)
    out["own_keys_left"].append(
        store.check([f"lgbm_hostgather/t/{seq}/{rank}"]))
out["modules"] = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "lightgbm_tpu"))
json.dump(out, open(spec["out"].format(rank=rank), "w"))
'''

EXIT_SCRIPT = r'''
import atexit, json, sys
import torch
torch.set_num_threads(1)
spec = json.load(open(sys.argv[1])); rank = int(sys.argv[2])
import torch.distributed as dist
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.parallel import comm


def report():
    # registered before the world is joined, so it runs after the port's
    # own exit hook
    json.dump({"initialized_at_exit": dist.is_initialized()},
              open(spec["out"].format(rank=rank), "w"))


atexit.register(report)
cfg = lgt.Config.from_params(dict(
    machines=spec["machines"], num_machines=spec["world"],
    local_listen_port=spec["ports"][rank], time_out=1, device="cpu"))
assert comm.init_distributed(cfg)
t = torch.ones(4)
dist.all_reduce(t)
assert t.tolist() == [2.0] * 4
'''


def _exact_fobj(preds, ds):
    """Gradients on a 1/64 grid, unit hessians: every f32 sum exact."""
    y = ds.get_label()
    g = np.clip(np.round((preds - y) * 64) / 64.0, -2.0, 2.0)
    return g, np.ones_like(g)


def _dense(n=1500, F=12, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, F)
    X[rng.rand(n, F) < 0.05] = np.nan
    y = X[:, 0] * 2 + np.nan_to_num(X[:, 3]) + rng.rand(n) * 0.5
    return X, y


def _categorical(n=1500, F=12, seed=4):
    """``_dense``'s features with column 2 an integer category; the label
    stays inside the gradients' clip range."""
    X, _ = _dense(n, F, seed)
    rng = np.random.RandomState(seed + 1)
    cat = rng.randint(0, 8, size=n)
    X[:, 2] = cat
    y = (0.5 * np.nan_to_num(X[:, 0]) + 0.75 * np.isin(cat, (1, 4, 6))
         + 0.25 * rng.rand(n))
    return X, y


def _binary(n=1500, F=10, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, F)
    y = (X[:, 0] + rng.rand(n) * 0.3 > 0.6).astype(np.float64)
    return X, y


def _three_classes(n=1500, F=10, seed=1):
    X, _ = _binary(n, F, seed)
    y = np.digitize(X[:, 0] + X[:, 1] * 0.5, [0.5, 1.0]).astype(np.float64)
    return X, y


def _mixed_sparse(n=1200, dense=4, groups=3, per_group=20, seed=3):
    """Dense columns and mutually exclusive flag groups: bundles form
    (the JAX package's EFB test shape, ``test_torch_efb.py``)."""
    rng = np.random.RandomState(seed)
    Xd = rng.rand(n, dense)
    flags = np.zeros((n, groups * per_group))
    picks = rng.randint(0, per_group, size=(n, groups))
    for g in range(groups):
        flags[np.arange(n), g * per_group + picks[:, g]] = 1.0
    X = np.concatenate([Xd, flags], axis=1)
    y = (Xd[:, 0] + 0.3 * (picks[:, 0] > per_group // 2)
         + 0.1 * rng.randn(n) > 0.65).astype(np.float64)
    return X, y


EXACT = dict(objective="regression", num_leaves=15, learning_rate=0.5,
             boost_from_average=False, min_data_in_leaf=5, metric="none",
             seed=5, bagging_fraction=0.7, bagging_freq=2,
             feature_fraction=0.8, enable_bundle="false")
EFB = dict(EXACT, enable_bundle="true", bagging_freq=0,
           feature_fraction=1.0)
GOSS = dict(EXACT, boosting="goss", bagging_freq=0, top_rate=0.3,
            other_rate=0.2)
FLOATS = dict(objective="binary", num_leaves=15, min_data_in_leaf=5,
              metric="none", bagging_fraction=0.8, bagging_freq=1,
              feature_fraction=0.9)


def _cases(world, datadir):
    """(name, params, data, fobj, jax oracle) of a world's trainings."""
    X, y = _dense()
    np.savez(os.path.join(datadir, "dense.npz"), X=X, y=y)
    Xc, yc = _categorical()
    np.savez(os.path.join(datadir, "cat.npz"), X=Xc, y=yc)
    Xs, ys = _mixed_sparse()
    np.savez(os.path.join(datadir, "efb.npz"), X=Xs, y=ys)
    Xb, yb = _binary()
    np.savez(os.path.join(datadir, "binary.npz"), X=Xb, y=yb)
    Xm, ym = _three_classes()
    np.savez(os.path.join(datadir, "multiclass.npz"), X=Xm, y=ym)
    cases = [(tl, dict(EXACT, tree_learner=tl), "dense", True, True)
             for tl in ("data", "feature", "voting")]
    cases += [(f"{tl}_cat", dict(EXACT, tree_learner=tl,
                                 categorical_feature="2"), "cat", True, True)
              for tl in ("data", "feature", "voting")]
    cases += [(f"{tl}_floats", dict(FLOATS, tree_learner=tl), "binary",
               False, False) for tl in ("data", "feature")]
    if world == 2:
        cases += [(f"{tl}_efb", dict(EFB, tree_learner=tl), "efb", True,
                   True) for tl in ("data", "feature")]
        # the other boosting modes and K > 1 models, against serial
        cases += [(f"data_{mode}", dict(FLOATS, tree_learner="data",
                                        **extra), "binary", False, False)
                  for mode, extra in (
                      ("dart", dict(boosting="dart", drop_rate=0.5)),
                      ("rf", dict(boosting="rf")))]
        cases += [("data_multiclass",
                   dict(FLOATS, tree_learner="data", objective="multiclass",
                        num_class=3), "multiclass", False, False)]
        cases += [("data_goss", dict(GOSS, tree_learner="data"), "dense",
                   True, True)]
    return cases


_WORLDS = {}


def _world(world, tmp_path_factory):
    if world not in _WORLDS:
        d = str(tmp_path_factory.mktemp(f"world{world}"))
        cases = _cases(world, d)
        spec = {"cases": [dict(name=n, params=p,
                               data=os.path.join(d, f"{data}.npz"),
                               fobj=fobj, rounds=4)
                          for n, p, data, fobj, _ in cases]}
        _WORLDS[world] = (run_world(TRAIN_SCRIPT, world, spec, d), cases, d)
    return _WORLDS[world]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _world(2, tmp_path_factory)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _world(4, tmp_path_factory)


def _jax_text(params, data, world, fobj):
    d = np.load(data)
    return lgb.train(dict(params, num_machines=world, verbose=-1),
                     lgb.Dataset(d["X"], label=d["y"]), num_boost_round=4,
                     fobj=_exact_fobj if fobj else None).model_to_string()


def _serial_text(params, data, fobj):
    d = np.load(data)
    p = dict(params, device="cpu", verbose=-1, tree_learner="serial")
    return lgt.train(p, lgt.Dataset(d["X"], label=d["y"]),
                     num_boost_round=4,
                     fobj=_exact_fobj if fobj else None).model_to_string()


def _case(world_out, name):
    outs, cases, d = world_out
    for n, p, data, fobj, oracle in cases:
        if n == name:
            return outs, p, os.path.join(d, f"{data}.npz"), fobj
    raise KeyError(name)


# ------------------------------------------------------------ model texts

@pytest.mark.parametrize("name", ["data", "feature", "voting", "data_efb",
                                  "feature_efb", "data_goss", "data_cat",
                                  "feature_cat", "voting_cat"])
def test_world_of_two_text_equals_jax(world2, name):
    outs, params, data, fobj = _case(world2, name)
    want = _jax_text(params, data, 2, fobj)
    for rank, out in enumerate(outs):
        assert out["strategy"][name] == params["tree_learner"]
        assert out["texts"][name] == want, f"rank {rank}"
    if name.endswith("_cat"):
        assert "cat_threshold=" in want        # a categorical split
    if name.endswith("_efb"):
        assert all(o["bundled"][name] for o in outs)


@pytest.mark.parametrize("name", ["data", "feature", "voting", "data_cat",
                                  "feature_cat", "voting_cat"])
def test_world_of_four_text_equals_jax(world4, name):
    outs, params, data, fobj = _case(world4, name)
    want = _jax_text(params, data, 4, fobj)
    assert [o["texts"][name] == want for o in outs] == [True] * 4
    if name.endswith("_cat"):
        assert "cat_threshold=" in want


@pytest.mark.parametrize("world,name", [
    (2, "data_floats"), (2, "feature_floats"), (4, "data_floats"),
    (4, "feature_floats"), (2, "data_dart"), (2, "data_rf"),
    (2, "data_multiclass")])
def test_parallel_text_equals_serial_on_any_floats(world, name, world2,
                                                   world4):
    """Arbitrary floats: the integer reduction makes the data-parallel (and
    the feature-parallel) model the serial one, byte for byte — binary,
    and under data DART, RF and a 3-class softmax."""
    outs, params, data, fobj = _case(world2 if world == 2 else world4, name)
    want = _serial_text(params, data, fobj)
    assert [o["texts"][name] == want for o in outs] == [True] * world


def test_ranks_import_neither_jax_nor_the_jax_package(world2, world4):
    for outs, _, _ in (world2, world4):
        assert all(o["modules"] == [] for o in outs)


# ------------------------------------------------- comm classes, world 2

def _comm_inputs(seed=11, S=4, F=6, B=8, D=2, n=120):
    """Per-rank partial histograms of real rows (1/64-grid g, unit h) and
    the slots' global sums."""
    rng = np.random.RandomState(seed)
    local = np.zeros((D, S, F, B, 3), np.float32)
    rows = []
    for r in range(D):
        codes = rng.randint(0, B, size=(n, F))
        slot = rng.randint(0, S, size=n)
        g = np.round(rng.randn(n) * 64) / 64.0
        rows.append((codes, slot, g))
        for i in range(n):
            for f in range(F):
                local[r, slot[i], f, codes[i, f]] += (g[i], 1.0, 1.0)
    glob = local.sum(axis=0)
    tot = glob[:, 0].sum(axis=1)                                  # [S, 3]
    fok = np.ones(F, bool)
    fok[4] = False
    return dict(local=local, **{"global": glob},
                pg=tot[:, 0].astype(np.float32),
                ph=tot[:, 1].astype(np.float32),
                pc=tot[:, 2].astype(np.float32), fok=fok,
                nb=np.full(F, B, np.int32), mc=np.zeros(F, np.int32),
                db=np.zeros(F, np.int32), ic=np.zeros(F, bool),
                rows_X=np.concatenate([c for c, _, _ in rows]).astype(
                    np.uint8),
                rows_slot=np.concatenate([s for _, s, _ in rows]),
                rows_g=np.concatenate([g for _, _, g in rows]),
                rows_owner=np.repeat(np.arange(D), n))


_SPEC = dict(num_leaves=15, num_bins_padded=8, hist_slots=4, wave_size=4,
             max_depth=-1, lambda_l1=0.0, lambda_l2=1.0,
             min_data_in_leaf=3.0, min_sum_hessian_in_leaf=1e-3,
             min_gain_to_split=0.0)


def _efb_inputs(seed=13, S=4, D=2):
    """A real EFB plan of ``_mixed_sparse`` data (the port's, which is the
    JAX package's: ``test_torch_efb.py``), its tables padded to the block
    strategies' widths, and per-rank bundle-space partial histograms of
    the bundled rows (1/64-grid g, unit h; the padding columns hold code 0,
    as the learner's do)."""
    from lightgbm_tpu_torch.efb import build_code_feat, plan_bundles
    X, y = _mixed_sparse(n=400, seed=seed)
    ds = lgt.Dataset(X, label=y)
    ds.construct(lgt.Config.from_params({"verbose": -1}))
    cd = ds.constructed
    meta = cd.feature_meta_arrays()
    nb = meta["num_bins"].astype(np.int64)
    db = meta["default_bin"].astype(np.int64)
    plan = plan_bundles(cd.X_binned, nb, db, lgt.Config())
    F, G = cd.num_features, plan.num_groups
    F_pad, G_pad = -(-F // D) * D, -(-G // D) * D
    B = max(8, -(-cd.max_num_bin // 8) * 8)
    Bb = max(8, -(-plan.max_bundle_bins // 8) * 8)
    codes = np.pad(np.asarray(plan.X_bundled, np.int64),
                   ((0, 0), (0, G_pad - G)))
    rng = np.random.RandomState(seed)
    n = codes.shape[0]
    slot = rng.randint(0, S, size=n)
    g = np.round(rng.randn(n) * 64) / 64.0
    owner = rng.randint(0, D, size=n)
    local = np.zeros((D, S, G_pad, Bb, 3), np.float32)
    for i in range(n):
        for c in range(G_pad):
            local[owner[i], slot[i], c, codes[i, c]] += (g[i], 1.0, 1.0)
    glob = local.sum(axis=0)
    tot = glob[:, 0].sum(axis=1)
    fpad = F_pad - F
    fok = np.arange(F_pad) < F
    inp = dict(local=local, **{"global": glob},
               pg=tot[:, 0].astype(np.float32),
               ph=tot[:, 1].astype(np.float32),
               pc=tot[:, 2].astype(np.float32), fok=fok,
               nb=np.pad(nb, (0, fpad), constant_values=1).astype(np.int32),
               mc=np.pad(meta["missing_code"], (0, fpad)).astype(np.int32),
               db=np.pad(db, (0, fpad)).astype(np.int32),
               ic=np.zeros(F_pad, bool),
               col=np.pad(plan.col, (0, fpad)).astype(np.int32),
               lo=np.pad(plan.lo, (0, fpad)).astype(np.int32),
               hi=np.pad(plan.hi, (0, fpad)).astype(np.int32),
               off=np.pad(plan.off, (0, fpad)).astype(np.int32),
               unpack_bin=np.pad(plan.unpack_bin, (
                   (0, fpad), (0, B - plan.unpack_bin.shape[1])),
                   constant_values=-1).astype(np.int32),
               code_feat=build_code_feat(plan, G_pad, Bb, db),
               rows_X=codes.astype(np.uint8), rows_slot=slot, rows_g=g,
               rows_owner=owner)
    return inp, dict(_SPEC, num_features=F_pad, num_bins_padded=B,
                     hist_bins=Bb)


@pytest.fixture(scope="module")
def comm_world(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("comm"))
    inp = _comm_inputs()
    np.savez(os.path.join(d, "comm.npz"), **inp)
    efb, efb_spec = _efb_inputs()
    np.savez(os.path.join(d, "efb.npz"), **efb)
    spec = dict(data=os.path.join(d, "comm.npz"),
                spec=dict(_SPEC, num_features=6),
                efb=os.path.join(d, "efb.npz"), efb_spec=efb_spec)
    return run_world(COMM_SCRIPT, 2, spec, d), inp, efb, efb_spec


def _jax_comm(kind, inp, efb_spec=None):
    from lightgbm_tpu.grower import BundleDecode as JaxBundle
    axis = "features" if kind.startswith("feature") else "rows"
    mesh = Mesh(np.array(jax.devices()[:2]), (axis,))
    F = inp["nb"].shape[0]
    bundle = None
    if kind.endswith("_efb"):
        G = inp["local"].shape[2]
        bundle = JaxBundle(*[jnp.asarray(inp[k])
                             for k in JaxBundle._fields])
        c = {"data_efb": jcomm.DataParallelBundledComm,
             "feature_efb": jcomm.FeatureParallelBundledComm}[kind](
                 axis, 2, F, G, bundle.col)
        spec = JaxSpec(chunk_rows=256, **efb_spec)
    else:
        c = {"data": jcomm.DataParallelComm(axis, 2, F),
             "feature": jcomm.FeatureParallelComm(axis, 2, F),
             "voting": jcomm.VotingParallelComm(axis, 2, F, 2)}[kind]
        spec = JaxSpec(num_features=F, chunk_rows=256, **_SPEC)
    meta = [jnp.asarray(inp[k]) for k in ("fok", "nb", "mc", "db", "ic")]

    def fn(h, pg, ph, pc, *m):
        red = c.reduce_hist(h if kind.startswith("feature") else h[0])
        scan = None if bundle is None else c.localize_bundle(bundle)
        cand = c.find_splits(red, pg, ph, pc, c.block_meta(*m), spec, scan)
        return red[None], cand

    if kind.startswith("feature"):
        hist, h_spec = jnp.asarray(inp["global"]), P(None, axis)
    else:
        hist, h_spec = jnp.asarray(inp["local"]), P(axis)
    f = jax.jit(jcomm._shard_map(fn, mesh=mesh,
                                 in_specs=(h_spec,) + (P(),) * 8,
                                 out_specs=(P(axis), P())))
    red, cand = f(hist, jnp.asarray(inp["pg"]), jnp.asarray(inp["ph"]),
                  jnp.asarray(inp["pc"]), *meta)
    return np.asarray(red), {k: np.asarray(v)
                             for k, v in cand._asdict().items()}


@pytest.mark.parametrize("kind", ["data", "feature", "voting", "data_efb",
                                  "feature_efb"])
def test_comm_reduce_hist_and_find_splits_equal_jax(comm_world, kind):
    """Each comm class (the bundled ones on a real EFB plan's tables) at
    world 2 against the JAX class under ``shard_map``: the reduced
    histograms each rank holds and the split candidates, bit for bit."""
    outs, inp, efb, efb_spec = comm_world
    red, cand = _jax_comm(kind, efb if kind.endswith("_efb") else inp,
                          efb_spec)
    for rank, out in enumerate(outs):
        mine = out[kind]
        np.testing.assert_array_equal(np.asarray(mine["red"], np.float32),
                                      red[rank])
        for field, want in cand.items():
            got = np.asarray(mine["cand"][field])
            if field == "cat_mask":
                want = want.reshape(got.shape)
            np.testing.assert_array_equal(got.astype(want.dtype), want,
                                          err_msg=f"{kind} {field}")
    assert all(o["modules"] == [] for o in outs)


def test_collective_bytes_name_each_collective(comm_world):
    outs = comm_world[0]
    assert set(outs[0]["data"]["bytes"]) == {
        "psum_root_scalars", "psum_scatter_hist", "allgather_splits"}
    assert set(outs[0]["feature"]["bytes"]) == {"allgather_splits"}
    assert set(outs[0]["voting"]["bytes"]) == {
        "psum_root_scalars", "psum_votes_gains", "psum_selected_hist"}
    # S=4 slots x F=6 features x B=8 bins x 20 bytes (u64 g, u64 h, u32 c)
    assert outs[0]["data"]["bytes"]["psum_scatter_hist"] == 4 * 6 * 8 * 20
    assert tcomm.SerialComm(6).collective_bytes(4, 8) == {}


# ------------------------------------------------------ host-side copies

@pytest.mark.parametrize("args", [
    (10, 10, 1), (10, 10, 4), (2_000_000, 10, 4), (2_000_000, 300, 4),
    (2_000_000, 300, 4, 50), (1000, 300, 4), (1000, 300, 4, 20, "rows"),
    (2_000_000, 300, 4, 20, "features"), (2_000_000, 100, 2, 20, "rows"),
])
def test_choose_tree_learner_equals_jax(args):
    assert tcomm.choose_tree_learner(*args) == \
        jcomm.choose_tree_learner(*args)


class _Cfg:
    def __init__(self, machines="", machine_list_file=""):
        self.machines = machines
        self.machine_list_file = machine_list_file


@pytest.mark.parametrize("text", [
    "10.0.0.1:12400,10.0.0.2:12401", "host-a 80\nhost-b 81\n\n",
    " a:1 , b:65535 ", "10.0.0.1", "h:0", "h:65536", "h:x", ":80",
    "h:1:2", "a b c", "",
])
def test_parse_machine_list_equals_jax(text, tmp_path):
    def run(mod, cfg):
        try:
            return ("ok", mod.parse_machine_list(cfg))
        except ValueError as e:
            return ("err", str(e))
    assert run(tcomm, _Cfg(text)) == run(jcomm, _Cfg(text))
    path = tmp_path / "mlist.txt"
    path.write_text(text)
    assert run(tcomm, _Cfg("", str(path))) == run(jcomm, _Cfg("", str(path)))


@pytest.mark.parametrize("machines,port", [
    ([("127.0.0.1", 5), ("127.0.0.1", 6)], 6),
    ([("127.0.0.1", 5), ("10.255.255.1", 6)], 9),
    ([("127.0.0.1", 5), ("localhost", 5)], 5),
    ([("10.255.255.1", 5), ("10.255.255.2", 6)], 5),
    ([("localhost", 7), ("10.255.255.2", 7), ("127.0.0.1", 8)], 8),
])
def test_local_rank_equals_jax(machines, port):
    def run(mod):
        try:
            return ("ok", mod._local_rank(machines, port))
        except RuntimeError as e:
            return ("err", str(e))
    assert run(tcomm) == run(jcomm)


def test_retry_module_is_the_jax_package_copy():
    """``robustness/retry.py`` is the JAX package's module below its
    docstring, and behaves as it does on a seeded schedule."""
    from lightgbm_tpu.robustness import retry as jretry

    def body(mod):
        src = inspect.getsource(mod)
        return src[src.index("from __future__"):]
    assert body(tretry) == body(jretry)
    for mod in (tretry, jretry):
        assert issubclass(mod.PeerLostError, mod.CommTimeoutError)
    waits = {}
    for name, mod in (("port", tretry), ("jax", jretry)):
        calls, slept = [], []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("transient")
            return "done"
        import random
        got = mod.retry_call(flaky, what="op", attempts=4, base_delay=0.5,
                             max_delay=30, jitter=0.25, sleep=slept.append,
                             rng=random.Random(3))
        assert got == "done"
        waits[name] = slept
    assert waits["port"] == waits["jax"] and len(waits["port"]) == 2


def _store(world=2):
    return torch.distributed.TCPStore(
        "127.0.0.1", 0, world, True,
        timeout=datetime.timedelta(seconds=30), wait_for_workers=False)


def test_host_allgather_exchanges_in_rank_order_and_cleans_up(tmp_path):
    """Two rank processes exchange twice through the world's store; each
    rank's payload key is gone after the done-barrier."""
    outs = run_world(GATHER_SCRIPT, 2, {}, str(tmp_path))
    want = [{"rank": 0, "x": [0] * 3}, {"rank": 1, "x": [1] * 3}]
    for out in outs:
        assert out["got"] == [want, want]
        assert out["seqs"] == [0, 1]
        assert out["own_keys_left"] == [False, False]
        assert out["modules"] == []


def test_gloo_world_is_left_before_the_interpreter_finalizes(tmp_path):
    """A gloo world ``init_distributed`` joined is destroyed by an exit
    hook, before the interpreter's teardown: both ranks exit 0 with no
    group left."""
    outs = run_world(EXIT_SCRIPT, 2, {}, str(tmp_path))
    assert [o["initialized_at_exit"] for o in outs] == [False, False]


def test_host_allgather_names_tag_sequence_and_ranks_on_timeout(monkeypatch):
    monkeypatch.setenv("LGBM_TPU_COMM_RETRIES", "2")
    monkeypatch.setenv("LGBM_TPU_COMM_BACKOFF_BASE", "0.01")
    store = _store()
    seq = tcomm._host_allgather_seq[0]
    with pytest.raises(tretry.CommTimeoutError) as info:
        tcomm.host_allgather("mine", "binmappers", timeout_ms=400,
                             client=store, rank=0, world=2)
    assert isinstance(info.value, tretry.PeerLostError)
    assert info.value.rank == 1
    msg = str(info.value)
    assert "tag='binmappers'" in msg and f"seq={seq}" in msg
    assert "rank 0" in msg and "rank 1" in msg


def test_a_world_of_one_collapses_to_serial():
    ctx = tcomm.ParallelContext("voting", None, 0, 1, torch.device("cpu"))
    assert ctx.strategy == "serial" and ctx.coll is None
    assert isinstance(ctx.make_comm(5, 100), tcomm.SerialComm)
    assert ctx.pad_features_to(5) == 5 and ctx.pad_rows_multiple() == 1
    assert ctx.describe()["n_devices"] == 1
    jctx = jcomm.ParallelContext("voting", jax.devices()[:1])
    assert (ctx.strategy, ctx.axis_kind) == (jctx.strategy, jctx.axis_kind)
