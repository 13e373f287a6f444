"""Gang-consistent checkpoints, heartbeat leases, elastic resume and
streaming in a world of ``lightgbm_tpu_torch`` ranks
(``robustness/distributed.py``, ``boosting/gbdt.py``, ``engine.py``,
``cli.py``), held against the JAX package.

In process, one thread per rank over one store (a ``FakeKVStore`` over a
``HashStore``): the commit, the newest common epoch, falling back a whole
epoch together, the refusal when nothing verifies, the mixed-iteration
refusal, a solo resume that needs ``elastic``; the JAX package's
``verify_manifest`` / ``audit_manifest_dir`` accept a port gang directory
and the port's ``--verify`` gives the JAX exit codes; the leases (expiry
names the rank, attribution never raises, rate-limited beats, ``withdraw``
deletes the key, a lost store names its host); ``comm_loss_error``; and
that each of the keys ``gang_heartbeat_interval_s``,
``gang_lease_timeout_s``, ``elastic`` and ``tpu_reshard_on_resume``
changes what training does.

Real gloo worlds of two CPU processes (``_torch_world.run_world``), five
of them, with byte-equal model text as the bar: a data-parallel gang
whose rank 1 is SIGKILLed after two manifests (rank 0 exits 145 naming
rank 1), relaunched to the uninterrupted text, then resumed on one
process under ``elastic=true tpu_reshard_on_resume=true`` to the serial
text; a gang whose rank 0, the store's host, is killed (rank 1 exits 145
naming rank 0, never hangs); and streamed ``data`` (the serial text on
arbitrary floats, C25) and ``voting`` (the resident voting text), whose
stores are, byte for byte, the device sub-blocks of the JAX package's
interleaved ``HostShardStore``; and the command line's SIGTERM
checkpoint, sent to one rank, written by every rank at one boundary
(exit 143).

Alone this file takes about 35 s on the CPU (CHANGES.md).
"""
import os
import threading

import numpy as np
import pytest
import torch

from lightgbm_tpu.ops.stream import HostShardStore as JaxShardStore
from lightgbm_tpu.robustness import distributed as jdist
from lightgbm_tpu.robustness.checkpoint import main as jax_verify_main

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import observability as obs
from lightgbm_tpu_torch.parallel import comm
from lightgbm_tpu_torch.robustness import distributed as gdist
from lightgbm_tpu_torch.robustness.chaos import FakeKVStore
from lightgbm_tpu_torch.robustness.checkpoint import CheckpointError
from lightgbm_tpu_torch.robustness.checkpoint import main as verify_main
from lightgbm_tpu_torch.robustness.retry import (CommTimeoutError,
                                                 PeerLostError)
from lightgbm_tpu_torch.utils.log import LightGBMError

from _torch_world import run_world

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fast(monkeypatch):
    monkeypatch.setenv("LGBM_TPU_COMM_BACKOFF_BASE", "0.001")
    obs.reset_for_tests()
    yield
    obs.reset_for_tests()
    gdist.uninstall_gang_override()


def _payload(it, tree_learner="data"):
    return {"iteration": it, "config_fingerprint": "test-gang",
            "config": {"tree_learner": tree_learner},
            "state": {"n_devices": 2, "tree_learner": tree_learner},
            "model": list(range(64))}


def _gang(d, fn, world=2, kv=None, **kw):
    """``fn(coordinator)`` on one thread per rank over one store; the
    results in rank order, re-raising the first rank's failure."""
    kv = kv or FakeKVStore()
    results, failures = [None] * world, []

    def one(r):
        try:
            co = gdist.GangCheckpointCoordinator(
                d, client=kv, rank=r, world=world, timeout_ms=20_000, **kw)
            results[r] = fn(co)
        except Exception as e:                               # noqa: BLE001
            failures.append((r, e))

    ts = [threading.Thread(target=one, args=(r,)) for r in range(world)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    if failures:
        raise failures[0][1]
    return results


def _rot(path):
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(path, "wb").write(bytes(raw))


# ------------------------------------------------------ gang save + resolve

def test_gang_save_commits_manifest_and_all_shards(tmp_path):
    d = str(tmp_path / "gang")
    kv = FakeKVStore()
    paths = _gang(d, lambda co: co.save(_payload(2)), kv=kv)
    assert sorted(os.path.basename(p) for p in paths) == [
        "shard_0000000001_r0000.pkl", "shard_0000000001_r0001.pkl"]
    (epoch, mpath), = gdist.list_manifests(d)
    man = gdist.load_manifest(mpath)
    assert (epoch, man["world"], man["iteration"]) == (1, 2, 2)
    assert [s["rank"] for s in man["shards"]] == [0, 1]
    assert sorted(man) == sorted(["manifest_version", "epoch", "iteration",
                                  "world", "n_devices", "tree_learner",
                                  "config_fingerprint", "shards"])
    # the manifest key is deleted after the commit barrier
    assert not kv.check(["lgbm_gang/manifest/1"])
    assert "lgbm_gang/manifest/1" in kv.deleted


def test_gang_resolve_picks_newest_common_epoch(tmp_path):
    d = str(tmp_path)

    def run(co):
        co.save(_payload(2))
        co.save(_payload(4))
        return co.resolve_resume()

    shards = _gang(d, run)
    assert [os.path.basename(s) for s in shards] == [
        "shard_0000000002_r0000.pkl", "shard_0000000002_r0001.pkl"]


def test_gang_falls_back_a_full_epoch_together(tmp_path):
    d = str(tmp_path)
    _gang(d, lambda co: (co.save(_payload(2)), co.save(_payload(4))))
    _rot(os.path.join(d, "shard_0000000002_r0001.pkl"))
    shards = _gang(d, lambda co: co.resolve_resume())
    assert [os.path.basename(s) for s in shards] == [
        "shard_0000000001_r0000.pkl", "shard_0000000001_r0001.pkl"]
    assert obs.snapshot()["counters"]["fault.gang_fallback_epochs"] == 2


def test_gang_resolve_refuses_when_nothing_verifies(tmp_path):
    d = str(tmp_path)
    _gang(d, lambda co: co.save(_payload(2)))
    for name in os.listdir(d):
        if name.startswith("shard_"):
            _rot(os.path.join(d, name))
    with pytest.raises(CheckpointError, match="no epoch verifies"):
        _gang(d, lambda co: co.resolve_resume())


def test_gang_resolve_fresh_directory_is_none(tmp_path):
    assert _gang(str(tmp_path), lambda co: co.resolve_resume()) == \
        [None, None]


def test_solo_resume_of_gang_dir_requires_elastic(tmp_path):
    d = str(tmp_path)
    _gang(d, lambda co: co.save(_payload(2)))
    solo = gdist.GangCheckpointCoordinator(d, client=None, rank=0, world=1)
    with pytest.raises(LightGBMError, match="[Ee]lastic"):
        solo.resolve_resume()
    elastic = gdist.GangCheckpointCoordinator(d, client=None, rank=0,
                                              world=1, elastic=True)
    assert os.path.basename(elastic.resolve_resume()) == \
        "shard_0000000001_r0000.pkl"


def test_gang_save_refuses_mixed_iteration_manifest(tmp_path):
    with pytest.raises(CheckpointError, match="torn"):
        _gang(str(tmp_path), lambda co: co.save(_payload(2 + co.rank)))
    assert gdist.list_manifests(str(tmp_path)) == []


def test_gang_keeps_the_newest_epochs(tmp_path):
    d = str(tmp_path)
    _gang(d, lambda co: [co.save(_payload(2 * i)) for i in range(1, 5)],
          keep_last_n=2)
    assert [e for e, _ in gdist.list_manifests(d)] == [3, 4]
    assert sorted(n for n in os.listdir(d) if n.startswith("shard_")) == [
        f"shard_000000000{e}_r000{r}.pkl" for e in (3, 4) for r in (0, 1)]


def test_commit_barrier_names_a_dead_peer_at_the_lease_timeout(tmp_path):
    """Rank 1 never arrives: the barrier's lease probe raises
    ``PeerLostError`` naming it (comm loss, exit 145), not the barrier's
    ten-minute timeout."""
    kv = FakeKVStore()
    kv.set("lgbm_gang/manifest/1", b"{}")
    t = {"now": 0.0}
    lease = gdist.HeartbeatLease(client=kv, rank=0, world=2,
                                 lease_timeout_s=1.0, clock=lambda: t["now"])

    orig = lease.probe

    def probe():
        t["now"] += 0.5
        return orig()

    lease.probe = probe
    co = gdist.GangCheckpointCoordinator(str(tmp_path), client=kv, rank=0,
                                         world=2, lease=lease)
    co._allgather = lambda obj, tag: (
        [obj, obj] if tag != "gang_ckpt_meta"
        else [obj, dict(obj, rank=1, file="shard_0000000001_r0001.pkl")])
    with pytest.raises(PeerLostError, match="peer rank 1") as ei:
        co.save(_payload(2))
    assert ei.value.rank == 1


# -------------------------------------------- across the two packages

def test_jax_package_verifies_a_port_gang_directory(tmp_path):
    d = str(tmp_path)
    _gang(d, lambda co: (co.save(_payload(2)), co.save(_payload(4))))
    for (e1, p1, ok1, _), (e2, p2, ok2, _) in zip(
            gdist.audit_manifest_dir(d), jdist.audit_manifest_dir(d)):
        assert (e1, p1, ok1) == (e2, p2, ok2) and ok1
    for _, path in gdist.list_manifests(d):
        assert jdist.verify_manifest(path, d)[0]
        assert jdist.verify_manifest(path, d, only_rank=1)[0]


@pytest.mark.parametrize("damage,code", [(None, 0), ("newest", 1),
                                         ("all", 2)])
def test_verify_exit_codes_are_the_jax_packages(tmp_path, damage, code):
    d = str(tmp_path)
    _gang(d, lambda co: (co.save(_payload(2)), co.save(_payload(4))))
    if damage == "newest":
        os.unlink(os.path.join(d, "shard_0000000002_r0001.pkl"))
    elif damage == "all":
        for e in (1, 2):
            os.unlink(os.path.join(d, f"shard_000000000{e}_r0001.pkl"))
    assert verify_main(["--verify", d]) == code
    assert jax_verify_main(["--verify", d]) == code


# -------------------------------------------------------- heartbeat leases

class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _lease_pair(kv, clock, timeout_s=5.0):
    return [gdist.HeartbeatLease(client=kv, rank=r, world=2,
                                 lease_timeout_s=timeout_s, interval_s=0.0,
                                 clock=clock) for r in (0, 1)]


def test_lease_expiry_raises_peer_lost_naming_the_rank():
    kv, clock = FakeKVStore(), FakeClock()
    me, peer = _lease_pair(kv, clock)
    me.beat(force=True)
    peer.beat(force=True)
    assert me.check_peers() == {1: 0.0}
    clock.t = 4.0
    peer.beat()
    assert me.check_peers()[1] == 0.0
    clock.t = 9.5
    with pytest.raises(PeerLostError, match="peer rank 1") as ei:
        me.check_peers()
    assert ei.value.rank == 1


def test_lease_attribution_is_non_raising_and_names_peer():
    kv, clock = FakeKVStore(), FakeClock()
    me, peer = _lease_pair(kv, clock)
    me.beat(force=True)
    peer.beat(force=True)
    me.check_peers()
    clock.t = 11.0
    att = me.attribution()
    assert att["peer_lost"] == 1 and att["slowest_rank"] == 1
    assert att["peer_lease_ages_s"]["1"] == pytest.approx(11.0)


def test_lease_beat_is_rate_limited_and_withdraw_deletes():
    kv, clock = FakeKVStore(), FakeClock()
    lease = gdist.HeartbeatLease(client=kv, rank=0, world=2,
                                 lease_timeout_s=5.0, interval_s=2.0,
                                 clock=clock)
    assert lease.beat(force=True)
    assert not lease.beat()
    clock.t = 2.5
    assert lease.beat()
    assert kv.get("lgbm_gang/hb/0") == b"2"
    lease.withdraw()
    assert not kv.check(["lgbm_gang/hb/0"])


def test_lease_beat_failure_never_raises():
    class Dead(FakeKVStore):
        def set(self, *a, **kw):
            raise RuntimeError("store down")

    lease = gdist.HeartbeatLease(client=Dead(), rank=0, world=2,
                                 lease_timeout_s=5.0)
    assert lease.beat(force=True) is False


class _LostStore(FakeKVStore):
    """A store whose host is gone: every call fails as the TCPStore's
    client does."""

    def _lost(self, *a, **kw):
        raise torch.distributed.DistNetworkError(
            "Failed to recv, got 0 bytes. Connection was likely closed. "
            "Did the remote server shutdown or crash?")

    set = get = add = check = wait = _lost


def test_a_lost_store_names_its_host_rank_0():
    lease = gdist.HeartbeatLease(client=_LostStore(), rank=1, world=2,
                                 lease_timeout_s=5.0)
    with pytest.raises(PeerLostError) as ei:
        lease.check_peers()
    assert ei.value.rank == 0
    att = lease.attribution()
    assert att["peer_lost"] == 0 and att["store_lost"]
    with pytest.raises(PeerLostError, match="peer rank 0") as ei:
        comm.host_allgather("x", "t", timeout_ms=200, client=_LostStore(),
                            rank=1, world=2)
    assert ei.value.rank == 0


def test_comm_loss_error_maps_what_torch_raises():
    kv, clock = FakeKVStore(), FakeClock()
    me, peer = _lease_pair(kv, clock, timeout_s=1.0)
    me.beat(force=True)
    peer.beat(force=True)
    me.check_peers()
    gloo = RuntimeError("[gloo/transport/tcp/pair.cc:537] Read error "
                        "[127.0.0.1]:40001: Connection reset by peer")
    e = gdist.comm_loss_error(gloo, me)              # peer within its lease
    assert isinstance(e, PeerLostError) and e.rank == 1
    clock.t = 5.0
    e = gdist.comm_loss_error(gloo, me)              # its lease expired
    assert isinstance(e, PeerLostError) and "lease expired" in str(e)
    e = gdist.comm_loss_error(gloo, None)
    assert type(e) is CommTimeoutError
    store = torch.distributed.DistNetworkError("Broken pipe")
    e = gdist.comm_loss_error(store, me)
    assert isinstance(e, PeerLostError) and e.rank == 0
    assert gdist.comm_loss_error(ValueError("a shape mismatch"), me) is None


# ------------------------------------------ the keys change what training does

def _data(n=1500, F=8, seed=1):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, F)
    y = X[:, 0] * 3 + np.sin(X[:, 1] * 7) + rng.randn(n) * 0.3
    return X, y


BASE = dict(objective="regression", num_leaves=15, min_data_in_leaf=5,
            device="cpu", verbose=-1)


@pytest.mark.parametrize("timeout,interval,beats", [(0.0, 0.0, 0),
                                                    (30.0, 0.0, 9),
                                                    (3000.0, 1000.0, 1)])
def test_gang_lease_keys_arm_and_pace_the_lease(timeout, interval, beats):
    """In a (one-process stand-in of a) world, ``gang_lease_timeout_s`` > 0
    arms the lease and ``gang_heartbeat_interval_s`` paces its writes:
    armed, then before and after each of four batches, unless the interval
    holds them back. The peer's lease is kept fresh by a callback."""
    kv = FakeKVStore()
    gdist.install_gang_override(kv, rank=0, world=2)
    peer = gdist.HeartbeatLease(client=kv, rank=1, world=2,
                                lease_timeout_s=60.0)

    def keep_peer_alive(env):
        peer.beat(force=True)
    keep_peer_alive.before_iteration = True
    X, y = _data(400)
    lgt.train(dict(BASE, gang_lease_timeout_s=timeout,
                   gang_heartbeat_interval_s=interval),
              lgt.Dataset(X, label=y), num_boost_round=4,
              callbacks=[keep_peer_alive])
    counters = obs.snapshot()["counters"]
    # the stand-in peer's four beats are counted too
    assert counters.get("comm.heartbeat_beats", 0) == beats + 4
    assert not kv.check(["lgbm_gang/hb/0"])             # withdrawn at the end


def test_a_dead_peer_is_named_before_the_batch():
    """The pre-batch probe: a peer whose lease stops advancing raises
    ``PeerLostError`` naming it once ``gang_lease_timeout_s`` passes."""
    kv = FakeKVStore()
    gdist.install_gang_override(kv, rank=0, world=2)
    peer = gdist.HeartbeatLease(client=kv, rank=1, world=2,
                                lease_timeout_s=60.0)
    peer.beat(force=True)
    import time

    def slow(env):
        time.sleep(0.3)
    X, y = _data(400)
    with pytest.raises(PeerLostError, match="peer rank 1") as ei:
        lgt.train(dict(BASE, gang_lease_timeout_s=0.5,
                       gang_heartbeat_interval_s=0.0),
                  lgt.Dataset(X, label=y), num_boost_round=10,
                  callbacks=[slow])
    assert ei.value.rank == 1


def _gang_dir_of_two(tmp_path, X, y, rounds=4):
    """A gang directory as a world of two writes it (thread-per-rank on one
    store), from one process's training state relabelled as a 2-device
    data-parallel snapshot: what the elastic resume reads."""
    d = str(tmp_path / "gang")
    bst = lgt.train(dict(BASE), lgt.Dataset(X, label=y),
                    num_boost_round=rounds, keep_training_booster=True)
    from lightgbm_tpu_torch.robustness.checkpoint import (
        config_fingerprint, fingerprinted_config)
    state = bst._gbdt.checkpoint_state()
    state.update(n_devices=2, tree_learner="data")
    payload = {"config_fingerprint": config_fingerprint(bst.config),
               "config": fingerprinted_config(bst.config),
               "iteration": state["iter"], "state": state,
               "eval_history": {}, "booster": {"prev_trees": [],
                                               "best_iteration": 0,
                                               "best_score": {},
                                               "feature_names": []}}
    _gang(d, lambda co: co.save(payload))
    return d


def test_elastic_and_reshard_keys_gate_a_solo_resume(tmp_path):
    """A one-process resume of a two-rank gang directory: refused without
    ``elastic`` (the gang's world size), refused with ``elastic`` but
    without ``tpu_reshard_on_resume`` (the booster's row blocks), and with
    both it trains on to the uninterrupted text."""
    X, y = _data(600)
    d = _gang_dir_of_two(tmp_path, X, y)
    want = lgt.train(dict(BASE), lgt.Dataset(X, label=y),
                     num_boost_round=8).model_to_string()
    p = dict(BASE, checkpoint_dir=d, resume_from="auto")
    with pytest.raises(LightGBMError, match="[Ee]lastic"):
        lgt.train(p, lgt.Dataset(X, label=y), num_boost_round=8)
    with pytest.raises(LightGBMError, match="tpu_reshard_on_resume"):
        lgt.train(dict(p, elastic=True), lgt.Dataset(X, label=y),
                  num_boost_round=8)
    got = lgt.train(dict(p, elastic=True, tpu_reshard_on_resume=True),
                    lgt.Dataset(X, label=y), num_boost_round=8)
    assert got.model_to_string() == want


def test_reshard_is_no_longer_logged_as_meaningless(caplog):
    import logging
    from lightgbm_tpu_torch.config import check_port_supported
    with caplog.at_level(logging.INFO, logger="lightgbm_tpu_torch"):
        check_port_supported(lgt.Config.from_params(
            dict(tpu_reshard_on_resume=True, tpu_hist_chunk=4096)))
    msgs = [r.getMessage() for r in caplog.records]
    assert any("tpu_hist_chunk" in m for m in msgs)
    assert not any("tpu_reshard_on_resume" in m for m in msgs)


def test_a_learner_change_at_the_same_world_is_refused():
    X, y = _data(400)
    bst = lgt.Booster(params=dict(BASE), train_set=lgt.Dataset(X, label=y))
    bst.update()
    state = bst._gbdt.checkpoint_state()
    state["tree_learner"] = "data"
    with pytest.raises(LightGBMError, match="tree_learner"):
        bst._gbdt.restore_checkpoint_state(state)
    state.update(tree_learner="serial", n_devices=3)
    with pytest.raises(LightGBMError, match="device"):
        bst._gbdt.restore_checkpoint_state(state)


# ------------------------------------------------- real worlds of two ranks

GANG_SCRIPT = r'''
import json, os, signal, sys
import numpy as np, torch
torch.set_num_threads(1)
spec = json.load(open(sys.argv[1])); rank = int(sys.argv[2])
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.robustness.distributed import list_manifests
from lightgbm_tpu_torch.robustness.retry import CommRetryError
net = dict(machines=spec["machines"], num_machines=spec["world"],
           local_listen_port=spec["ports"][rank], time_out=1)
d = np.load(spec["data"])
params = dict(spec["params"], **net)
cbs = []
if spec.get("kill_rank") == rank:
    def _kill(env):
        # after the checkpoint callback: the gang has banked its manifests
        if len(list_manifests(params["checkpoint_dir"])) >= 2:
            os.kill(os.getpid(), signal.SIGKILL)
    _kill.order = 60
    cbs.append(_kill)
out = {"modules": sorted(m for m in sys.modules
                         if m.split(".")[0] in ("jax", "lightgbm_tpu"))}
try:
    b = lgt.train(params, lgt.Dataset(d["X"], label=d["y"]),
                  num_boost_round=spec["rounds"], callbacks=cbs)
    out["text"] = b.model_to_string()
except CommRetryError as e:
    out.update(lost=getattr(e, "rank", None), error=str(e)[:500])
    json.dump(out, open(spec["out"].format(rank=rank), "w"))
    sys.stdout.flush()
    os._exit(145)
json.dump(out, open(spec["out"].format(rank=rank), "w"))
'''

GANG = dict(BASE, tree_learner="data", checkpoint_interval=2,
            checkpoint_keep_last_n=0, gang_heartbeat_interval_s=0.05,
            gang_lease_timeout_s=3.0, hang_timeout_s=20.0,
            hang_median_factor=0.0, hang_action="abort")


def _out(workdir, rank):
    import json
    return json.load(open(os.path.join(workdir, f"out_{rank}.json")))


@pytest.fixture(scope="module")
def gang_run(tmp_path_factory):
    """Generation 0 of a data-parallel gang, rank 1 SIGKILLed after two
    manifests; generation 1 relaunched with ``resume_from=auto``."""
    d = str(tmp_path_factory.mktemp("gang"))
    X, y = _data()
    np.savez(os.path.join(d, "data.npz"), X=X, y=y)
    params = dict(GANG, checkpoint_dir=os.path.join(d, "ck"))
    spec = dict(data=os.path.join(d, "data.npz"), params=params, rounds=8)
    g0 = os.path.join(d, "g0")
    rcs = run_world(GANG_SCRIPT, 2, dict(spec, kill_rank=1), g0,
                    expect_rc=145)
    gen0 = ([rc for rc, _ in rcs], _out(g0, 0),
            sorted(os.listdir(params["checkpoint_dir"])))
    g1 = os.path.join(d, "g1")
    gen1 = run_world(GANG_SCRIPT, 2, dict(spec, params=dict(
        params, resume_from="auto")), g1)
    return dict(X=X, y=y, gen0=gen0, gen1=gen1, params=params)


def _serial(X, y, rounds, **extra):
    return lgt.train(dict(BASE, **extra), lgt.Dataset(X, label=y),
                     num_boost_round=rounds).model_to_string()


def test_a_killed_rank_is_named_by_the_survivor_with_exit_145(gang_run):
    rcs, out0, files = gang_run["gen0"]
    assert rcs == [145, -9]
    assert out0["lost"] == 1 and "rank 1" in out0["error"]
    assert out0["modules"] == []
    assert [f for f in files if f.startswith("manifest_")] == [
        "manifest_0000000001.json", "manifest_0000000002.json"]


def test_the_relaunched_gang_resumes_to_the_uninterrupted_text(gang_run):
    X, y = gang_run["X"], gang_run["y"]
    want = _serial(X, y, 8)       # data-parallel text == serial text (C25)
    assert [o["text"] == want for o in gang_run["gen1"]] == [True, True]
    assert all(o["modules"] == [] for o in gang_run["gen1"])


def test_elastic_two_to_one_resume_gives_the_serial_text(gang_run,
                                                        tmp_path):
    """The gang's directory (epochs of a world of two, plus the relaunch's)
    resumed by one process, ``elastic=true tpu_reshard_on_resume=true``,
    from its newest epoch at iteration 8, trained on to 12."""
    import shutil
    X, y = gang_run["X"], gang_run["y"]
    d = str(tmp_path / "ck")
    shutil.copytree(gang_run["params"]["checkpoint_dir"], d)
    p = dict(gang_run["params"], checkpoint_dir=d, num_machines=2,
             resume_from="auto", elastic=True, tpu_reshard_on_resume=True,
             checkpoint_interval=0)
    for k in ("gang_lease_timeout_s", "hang_timeout_s"):
        p.pop(k)
    got = lgt.train(p, lgt.Dataset(X, label=y), num_boost_round=12)
    assert got.model_to_string() == _serial(X, y, 12)


def test_a_killed_store_host_is_named_by_the_survivor(tmp_path):
    """Rank 0 hosts the ``TCPStore``: when it dies every store call of rank
    1 fails at once, and rank 1 exits 145 naming rank 0 — no hang."""
    d = str(tmp_path)
    X, y = _data()
    np.savez(os.path.join(d, "data.npz"), X=X, y=y)
    params = dict(GANG, checkpoint_dir=os.path.join(d, "ck"))
    rcs = run_world(GANG_SCRIPT, 2, dict(data=os.path.join(d, "data.npz"),
                                         params=params, rounds=8,
                                         kill_rank=0),
                    os.path.join(d, "w"), deadline=90, expect_rc=145)
    assert [rc for rc, _ in rcs] == [-9, 145]
    out1 = _out(os.path.join(d, "w"), 1)
    assert out1["lost"] == 0 and "rank 0" in out1["error"]


STREAM_SCRIPT = r'''
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
spec = json.load(open(sys.argv[1])); rank = int(sys.argv[2])
import lightgbm_tpu_torch as lgt
net = dict(machines=spec["machines"], num_machines=spec["world"],
           local_listen_port=spec["ports"][rank], time_out=1)
d = np.load(spec["data"])
out = {"modules": []}
for tl in ("data", "voting"):
    for res in ("device", "stream"):
        b = lgt.train(dict(spec["params"], tree_learner=tl, tpu_residency=res,
                           **net),
                      lgt.Dataset(d["X"], label=d["y"]),
                      num_boost_round=spec["rounds"],
                      keep_training_booster=True)
        out[f"{tl}_{res}"] = b.model_to_string()
        g = b._gbdt
        if res == "stream":
            st = g._stream_store
            np.save(spec["out"].format(rank=rank) + f".{tl}.npy",
                    np.stack(st.shards))
            out[f"{tl}_crc"] = st.checksums
            out[f"{tl}_geo"] = [g.num_rows, st.shard_rows, st.n_shards,
                                st.code_mode, g._grower.flag_reads,
                                g._grower.waves_run]
out["modules"] = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "lightgbm_tpu"))
json.dump(out, open(spec["out"].format(rank=rank), "w"))
'''


@pytest.fixture(scope="module")
def stream_world(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("stream"))
    X, y = _data(seed=5)
    np.savez(os.path.join(d, "data.npz"), X=X, y=y)
    params = dict(BASE, tpu_stream_shard_rows=128)
    outs = run_world(STREAM_SCRIPT, 2, dict(data=os.path.join(d, "data.npz"),
                                            params=params, rounds=4), d)
    return dict(X=X, y=y, outs=outs, dir=d, params=params)


def test_streamed_data_parallel_gives_the_serial_text(stream_world):
    """C25 on arbitrary floats: the streamed data-parallel wave reduces the
    accumulator's int64 sums before the conversion."""
    X, y = stream_world["X"], stream_world["y"]
    want = _serial(X, y, 4)
    for o in stream_world["outs"]:
        assert o["data_stream"] == o["data_device"] == want
        assert o["modules"] == []
        rows, shard_rows, n_shards, mode, reads, waves = o["data_geo"]
        assert (rows, shard_rows, n_shards, mode) == (768, 128, 6, "u8")
        assert reads == waves > 0


def test_streamed_voting_gives_the_resident_voting_text(stream_world):
    outs = stream_world["outs"]
    assert [o["voting_stream"] == o["voting_device"] for o in outs] == \
        [True, True]
    assert outs[0]["voting_stream"] == outs[1]["voting_stream"]


@pytest.mark.parametrize("tl", ["data", "voting"])
def test_rank_stores_are_the_jax_interleaved_stores_sub_blocks(stream_world,
                                                               tl):
    """Each rank's ``HostShardStore`` holds its own row block; at the same
    geometry its shard ``i`` is, byte for byte, the device-``r`` sub-block
    of the JAX package's ``HostShardStore(n_devices=2)`` shard ``i``, and
    the CRC32 of each is the sub-block's."""
    import zlib
    X, y = stream_world["X"], stream_world["y"]
    ds = lgt.Dataset(X, label=y, params=stream_world["params"])
    ds.construct(lgt.Config.from_params(stream_world["params"]))
    codes = ds.constructed.X_binned
    R, D, per_dev = 128, 2, 768
    jstore = JaxShardStore(codes, n_rows_padded=D * per_dev,
                           num_cols=codes.shape[1], local_shard_rows=R,
                           n_devices=D, code_mode="u8")
    for r in range(D):
        mine = np.load(os.path.join(stream_world["dir"],
                                    f"out_{r}.json.{tl}.npy"))
        out = stream_world["outs"][r]
        assert mine.shape[0] == jstore.n_shards
        for i in range(jstore.n_shards):
            sub = np.ascontiguousarray(jstore.shards[i][r * R:(r + 1) * R])
            assert np.array_equal(mine[i], sub)
            assert out[f"{tl}_crc"][i] == zlib.crc32(sub) & 0xFFFFFFFF


SIGTERM_SCRIPT = r'''
import json, os, signal, sys
import torch
torch.set_num_threads(1)
spec = json.load(open(sys.argv[1])); rank = int(sys.argv[2])
from lightgbm_tpu_torch import cli
train_fn = cli.train_fn


def train(*a, callbacks=None, **kw):
    def preempt(env):
        # rank 0 alone is preempted, after its third iteration
        if rank == 0 and env.iteration == 2:
            os.kill(os.getpid(), signal.SIGTERM)
    preempt.order = 45              # before the signal checkpoint's 50
    return train_fn(*a, callbacks=list(callbacks or []) + [preempt], **kw)


cli.train_fn = train
cli.main(["task=train", f"data={spec['data']}", "objective=regression",
          "num_leaves=15", "min_data_in_leaf=5", "tree_learner=data",
          "num_iterations=50", "device=cpu", "verbose=-1", "time_out=1",
          f"checkpoint_dir={spec['ck']}", "checkpoint_interval=100",
          f"num_machines={spec['world']}", f"machines={spec['machines']}",
          f"local_listen_port={spec['ports'][rank]}",
          f"output_model={spec['out'].format(rank=rank)}.model"])
'''


def test_sigterm_to_one_rank_checkpoints_every_rank_and_exits_143(tmp_path):
    """The CLI's SIGTERM checkpoint in a world: the ranks agree on the
    boundary through the store, every rank writes its shard of one epoch,
    and every rank exits 143 (through ``os._exit``)."""
    d = str(tmp_path)
    X, y = _data()
    data = os.path.join(d, "train.tsv")
    np.savetxt(data, np.column_stack([y, X]), delimiter="\t", fmt="%.10g")
    ck = os.path.join(d, "ck")
    rcs = run_world(SIGTERM_SCRIPT, 2, dict(data=data, ck=ck),
                    os.path.join(d, "w"), expect_rc=143)
    assert [rc for rc, _ in rcs] == [143, 143], rcs
    (epoch, path), = gdist.list_manifests(ck)
    ok, detail = gdist.verify_manifest(path, ck)
    assert ok and gdist.load_manifest(path)["iteration"] == 3, detail
    assert [s["rank"] for s in gdist.load_manifest(path)["shards"]] == [0, 1]
