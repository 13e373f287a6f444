"""The host wiring of ``lightgbm_tpu_torch``'s distributed training, on gloo
worlds of two CPU processes: ``Booster.set_network``, ``LGBM_NetworkInit``
(the C API), the command line with ``machines`` / ``machine_list_file`` /
``local_listen_port`` and its comm-loss exit, distributed bin finding,
lambdarank under ``is_pre_partition``, and what a world refused before
ROADMAP A16b's streaming and checkpoints were ported. The ports of ``tests/test_multihost.py`` and
``test_distributed.py`` of the JAX package.

Ranks run the scripts held below as strings (``_torch_world.run_world``),
each with ``torch.set_num_threads(1)``; none imports JAX or
``lightgbm_tpu``. The data-parallel learner reduces B1's int64 sums, so a
world of two trains the serial text byte for byte, and that is the bar
here; lambdarank is also held to the JAX package's ``num_machines=2``
trees at ``test_torch_ranking.py``'s bar (the same splits, leaves within
1e-5 of its f64 histograms).

Alone this file takes about 25 s on the CPU (CHANGES.md).
"""
import os

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import cli
from lightgbm_tpu_torch.robustness.retry import PeerLostError

from _torch_world import run_world

torch.set_num_threads(1)

API_SCRIPT = r'''
import json, os, sys
import numpy as np, torch
torch.set_num_threads(1)
spec = json.load(open(sys.argv[1])); rank = int(sys.argv[2])
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.parallel import comm
from lightgbm_tpu_torch.utils.log import LightGBMError
net = dict(machines=spec["machines"], num_machines=spec["world"],
           local_listen_port=spec["ports"][rank], time_out=1,
           device="cpu", verbose=-1)
d = np.load(spec["data"])
X, y = d["X"], d["y"]
out = {}

# Booster.set_network, then training through update()
bst = lgt.Booster(params=dict(spec["params"], device="cpu", verbose=-1))
bst.set_network(spec["machines"], local_listen_port=spec["ports"][rank],
                listen_time_out=1, num_machines=spec["world"])
for i in range(spec["rounds"]):
    bst.update(train_set=lgt.Dataset(X, label=y) if i == 0 else None)
out["set_network"] = bst.model_to_string()
out["strategy"] = bst._gbdt.pctx.strategy

# distributed bin finding: each rank finds half the mappers
seq = comm._host_allgather_seq[0]
ds = lgt.Dataset(X, label=y, params=net)
ds.construct(lgt.Config.from_params(net))
out["mappers"] = [[m.num_bin, m.missing_type, m.default_bin,
                   [float(v) for v in np.asarray(m.bin_upper_bound)]]
                  for m in ds.constructed.mappers]
out["exchanges"] = comm._host_allgather_seq[0] - seq

# lambdarank on pre-partitioned rows: whole queries per rank
r = np.load(spec["rank_data"])
lo, hi = r["row_split"][rank], r["row_split"][rank + 1]
q = r["q_split"]
b = lgt.train(dict(net, objective="lambdarank", num_leaves=7,
                   min_data_in_leaf=5, tree_learner="data",
                   is_pre_partition=True, metric="none"),
              lgt.Dataset(r["X"][lo:hi], label=r["y"][lo:hi],
                          group=r["sizes"][q[rank]:q[rank + 1]]),
              num_boost_round=4, keep_training_booster=True)
out["lambdarank"] = b.model_to_string()
out["block_counts"] = b._gbdt._block_counts

# what a world refused before ROADMAP A16b was ported: each now trains
# (a refusal would be recorded), every rank to the same text
refused, texts = {}, {}
for name, extra, kw in (
        ("stream", dict(tree_learner="data", tpu_residency="stream"), {}),
        ("checkpoint", dict(tree_learner="voting", checkpoint_interval=1,
                            checkpoint_dir=spec["ckpt"] + str(rank)), {}),
        ("resume", dict(tree_learner="data"), dict(resume_from="auto"))):
    try:
        texts[name] = lgt.train(dict(net, objective="binary", **extra),
                                lgt.Dataset(X, label=y), num_boost_round=1,
                                **kw).model_to_string()
        refused[name] = None
    except LightGBMError as e:
        refused[name] = str(e)
out["refused"] = refused
out["texts"] = texts
out["ckpt_files"] = sorted(os.listdir(spec["ckpt"] + str(rank)))
out["modules"] = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "lightgbm_tpu"))
json.dump(out, open(spec["out"].format(rank=rank), "w"))
'''

CAPI_SCRIPT = r'''
import ctypes, json, sys
import numpy as np, torch
torch.set_num_threads(1)
spec = json.load(open(sys.argv[1])); rank = int(sys.argv[2])
from lightgbm_tpu_torch import capi_shim
lib = capi_shim.load_shim()
d = np.load(spec["data"])
X = np.ascontiguousarray(d["X"], dtype=np.float64)
y = np.ascontiguousarray(d["y"], dtype=np.float32)
n, f = X.shape
rets = [lib.LGBM_NetworkInit(spec["machines"].encode(), spec["ports"][rank],
                             1, spec["world"])]
ds, bst, fin = ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_int()
rets.append(lib.LGBM_DatasetCreateFromMat(
    X.ctypes.data_as(ctypes.c_void_p), 1, n, f, 1, b"device=cpu", None,
    ctypes.byref(ds)))
rets.append(lib.LGBM_DatasetSetField(
    ds, b"label", y.ctypes.data_as(ctypes.c_void_p), n, 0))
rets.append(lib.LGBM_BoosterCreate(ds, spec["params"].encode(),
                                   ctypes.byref(bst)))
for _ in range(spec["rounds"]):
    rets.append(lib.LGBM_BoosterUpdateOneIter(bst, ctypes.byref(fin)))
path = spec["out"].format(rank=rank) + ".model"
rets.append(lib.LGBM_BoosterSaveModel(bst, 0, path.encode()))
rets += [lib.LGBM_BoosterFree(bst), lib.LGBM_DatasetFree(ds),
         lib.LGBM_NetworkFree()]
json.dump({"rets": rets, "text": open(path).read(),
           "error": lib.LGBM_GetLastError().decode(),
           "modules": sorted(m for m in sys.modules
                             if m.split(".")[0] in ("jax", "lightgbm_tpu"))},
          open(spec["out"].format(rank=rank), "w"))
'''

CLI_SCRIPT = r'''
import json, os, sys
import torch
torch.set_num_threads(1)
spec = json.load(open(sys.argv[1])); rank = int(sys.argv[2])
from lightgbm_tpu_torch import cli
model = spec["out"].format(rank=rank) + ".model"
# rank 0 names the machines inline, rank 1 reads them from a file (one
# "host port" a line, examples/parallel_learning/mlist.txt there)
mlist = spec["out"].format(rank=rank) + ".mlist"
with open(mlist, "w") as fh:
    fh.write("\n".join(m.replace(":", " ")
                       for m in spec["machines"].split(",")))
net = ([f"machines={spec['machines']}"] if rank == 0 else
       [f"machine_list_file={mlist}"])
rc = cli.main(["task=train", f"data={spec['data']}", "device=cpu",
               f"output_model={model}", f"num_machines={spec['world']}",
               f"local_listen_port={spec['ports'][rank]}", "time_out=1",
               *net, *spec["args"]])
json.dump({"rc": rc, "text": open(model).read(),
           "modules": sorted(m for m in sys.modules
                             if m.split(".")[0] in ("jax", "lightgbm_tpu"))},
          open(spec["out"].format(rank=rank), "w"))
'''

PARAMS = dict(objective="binary", num_leaves=7, min_data_in_leaf=5,
              tree_learner="data", metric="none")


def _binary(n=800, F=6, seed=17):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, F)
    X[rng.rand(n, F) < 0.03] = np.nan
    y = (np.nan_to_num(X[:, 0]) + 0.3 * rng.rand(n) > 0.6).astype(np.float64)
    return X, y


def _rank_problem(n=1200, seed=2):
    """Query groups over coarse features (each value appears often, so a
    rank's sample finds the mappers the whole data gives)."""
    rng = np.random.RandomState(seed)
    X = rng.randint(0, 16, size=(n, 6)) / 15.0
    sizes, total = [], 0
    while total < n:
        q = int(min(rng.randint(5, 40), n - total))
        sizes.append(q)
        total += q
    latent = X[:, 0] * 3 + X[:, 1] ** 2 + rng.randn(n) * 0.5
    y = np.searchsorted(np.quantile(latent, [0.5, 0.75, 0.9]),
                        latent).astype(np.float64)
    return X, y, np.array(sizes, np.int64)


def _serial(params, X, y, rounds, **kw):
    p = dict(params, device="cpu", verbose=-1, tree_learner="serial")
    return lgt.train(p, lgt.Dataset(X, label=y, **kw),
                     num_boost_round=rounds).model_to_string()


@pytest.fixture(scope="module")
def api_world(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("api"))
    X, y = _binary()
    np.savez(os.path.join(d, "data.npz"), X=X, y=y)
    Xr, yr, sizes = _rank_problem()
    q_split = [0, len(sizes) // 2, len(sizes)]
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    row_split = [int(bounds[q]) for q in q_split]
    np.savez(os.path.join(d, "rank.npz"), X=Xr, y=yr, sizes=sizes,
             q_split=q_split, row_split=row_split)
    spec = dict(data=os.path.join(d, "data.npz"),
                rank_data=os.path.join(d, "rank.npz"), params=PARAMS,
                rounds=4, ckpt=os.path.join(d, "ckpt"))
    return run_world(API_SCRIPT, 2, spec, d), (X, y), (Xr, yr, sizes)


def test_set_network_trains_a_world_of_two_to_the_serial_text(api_world):
    outs, (X, y), _ = api_world
    want = _serial(PARAMS, X, y, 4)
    assert [o["set_network"] == want for o in outs] == [True, True]
    assert [o["strategy"] for o in outs] == ["data", "data"]
    assert all(o["modules"] == [] for o in outs)


def test_distributed_bin_finding_gives_the_serial_mappers(api_world):
    outs, (X, y), _ = api_world
    ds = lgt.Dataset(X, label=y)
    ds.construct(lgt.Config.from_params({"verbose": -1}))
    want = [[m.num_bin, m.missing_type, m.default_bin,
             [float(v) for v in np.asarray(m.bin_upper_bound)]]
            for m in ds.constructed.mappers]
    # (a NaN bin bound is equal to a NaN bound here)
    np.testing.assert_equal(outs[0]["mappers"], want)
    np.testing.assert_equal(outs[1]["mappers"], want)
    # the mappers crossed between the ranks: one exchange each
    assert [o["exchanges"] for o in outs] == [1, 1]


def test_lambdarank_under_pre_partition(api_world):
    outs, _, (X, y, sizes) = api_world
    params = dict(objective="lambdarank", num_leaves=7, min_data_in_leaf=5,
                  metric="none")
    want = _serial(params, X, y, 4, group=sizes)
    assert [o["lambdarank"] == want for o in outs] == [True, True]
    half = len(sizes) // 2
    assert outs[0]["block_counts"] == [int(sizes[:half].sum()),
                                       int(sizes[half:].sum())]
    # and the JAX package's two-device trees, at the ranking test's bar
    jax_text = lgb.train(dict(params, num_machines=2, tree_learner="data",
                              verbose=-1, tpu_hist_f64=True),
                         lgb.Dataset(X, label=y, group=sizes),
                         num_boost_round=4).model_to_string()

    def splits(text):
        return [ln.split("=", 1)[1].split() for ln in text.splitlines()
                if ln.startswith(("split_feature=", "threshold="))]

    def leaves(text):
        return np.array([float(v) for ln in text.splitlines()
                         if ln.startswith("leaf_value=")
                         for v in ln.split("=", 1)[1].split()])
    assert splits(want) == splits(jax_text)
    np.testing.assert_allclose(leaves(want), leaves(jax_text), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("name", ["stream", "checkpoint", "resume"])
def test_a_world_refuses_naming_a16b(api_world, name):
    """These refused naming ROADMAP A16b; a world of two now trains them:
    streamed and resumed (from nothing: a fresh start) data-parallel to the
    serial text, and voting with a gang checkpoint each rank's directory
    holds (its shard and the epoch's manifest)."""
    outs, (X, y), _ = api_world
    for o in outs:
        assert o["refused"][name] is None, o["refused"][name]
    assert outs[0]["texts"][name] == outs[1]["texts"][name]
    if name != "checkpoint":
        want = _serial(dict(objective="binary"), X, y, 1)
        assert outs[0]["texts"][name] == want
    else:
        for r, o in enumerate(outs):
            assert o["ckpt_files"] == ["manifest_0000000001.json",
                                       f"shard_0000000001_r000{r}.pkl"]


def test_network_init_trains_a_world_of_two_to_the_serial_text(tmp_path):
    from lightgbm_tpu_torch.capi_shim import load_shim
    load_shim()                  # built once here, not by racing ranks
    X, y = _binary(seed=5)
    np.savez(str(tmp_path / "data.npz"), X=X, y=y)
    params = "objective=binary num_leaves=7 min_data_in_leaf=5 " \
             "tree_learner=data metric=none verbose=-1 device=cpu"
    outs = run_world(CAPI_SCRIPT, 2, dict(data=str(tmp_path / "data.npz"),
                                          params=params, rounds=3),
                     str(tmp_path))
    want = _serial(PARAMS, X, y, 3)
    for o in outs:
        assert o["rets"] == [0] * len(o["rets"]), o["error"]
        assert o["text"] == want
        assert o["modules"] == []


def test_cli_trains_a_world_of_two_to_the_serial_text(tmp_path):
    X, y = _binary(seed=9)
    data = str(tmp_path / "train.tsv")
    np.savetxt(data, np.column_stack([y, np.nan_to_num(X, nan=-1.0)]),
               delimiter="\t", fmt="%.10g")
    args = ["objective=binary", "num_leaves=7", "min_data_in_leaf=5",
            "tree_learner=data", "num_iterations=3", "verbose=-1"]
    serial = str(tmp_path / "serial.model")
    assert cli.main(["task=train", f"data={data}", "device=cpu",
                     f"output_model={serial}", *args[:3],
                     "num_iterations=3", "verbose=-1"]) in (0, None)
    outs = run_world(CLI_SCRIPT, 2, dict(data=data, args=args),
                     str(tmp_path))
    with open(serial) as fh:
        want = fh.read()
    for o in outs:
        assert o["rc"] in (0, None)
        assert o["text"] == want
        assert o["modules"] == []


def test_cli_comm_loss_exits_145(monkeypatch, tmp_path):
    """A lost peer (``PeerLostError``, a ``CommTimeoutError``) ends the
    command line with the typed comm-loss status, beside the shard
    corruption exit (lightgbm_tpu/cli.py:192-217)."""
    X, y = _binary(n=100)
    data = str(tmp_path / "train.tsv")
    np.savetxt(data, np.column_stack([y, np.nan_to_num(X)]),
               delimiter="\t", fmt="%.10g")

    def lost(*args, **kwargs):
        raise PeerLostError("host_allgather tag='binmappers' seq=0: rank 0 "
                            "could not fetch rank 1's shard", rank=1)
    monkeypatch.setattr(cli, "train_fn", lost)
    with pytest.raises(SystemExit) as info:
        cli.main(["task=train", f"data={data}", "device=cpu",
                  "objective=binary", f"output_model={tmp_path}/m.txt"])
    assert info.value.code == cli.EXIT_COMM_LOST == 145
