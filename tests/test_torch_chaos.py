"""The port's chaos harness (``lightgbm_tpu_torch/robustness/chaos.py``)
held against the JAX package's (``lightgbm_tpu/robustness/chaos.py``).

The store doubles speak the ``torch.distributed`` ``Store`` API
(``FakeKVStore`` over a ``HashStore``); ``ChaosKVClient`` injects the JAX
harness's scripted and seeded faults through it, and
``install_kv_chaos`` reaches ``host_allgather`` and the gang protocol
through ``parallel.comm``'s store wrapper. ``corrupt_payload`` and
``nan_gradient_fobj`` give the JAX package's bytes and draws for one seed;
the hang callback and the killers are the JAX harness's too.

Alone this file takes about 5 s on the CPU (CHANGES.md).
"""
import datetime
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from lightgbm_tpu.robustness import chaos as jchaos

from lightgbm_tpu_torch.parallel import comm
from lightgbm_tpu_torch.robustness import chaos as tchaos
from lightgbm_tpu_torch.robustness import distributed as gdist
from lightgbm_tpu_torch.robustness.chaos import (ChaosKVClient, ChaosPlan,
                                                 FakeKVStore, KVTimeoutSim)
from lightgbm_tpu_torch.robustness.retry import CommRetryError

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fast_retries(monkeypatch):
    monkeypatch.setenv("LGBM_TPU_COMM_BACKOFF_BASE", "0.001")
    monkeypatch.setenv("LGBM_TPU_COMM_RETRIES", "3")
    yield
    tchaos.uninstall_kv_chaos()


# ------------------------------------------------------------ FakeKVStore

def test_fake_store_speaks_the_torch_store_api():
    kv = FakeKVStore(entries={"peer": b"x"})
    assert kv.get("peer") == b"x"
    kv.set("a", b"1")
    assert kv.add("n", 2) == 2 and kv.add("n", 0) == 2
    assert kv.check(["a", "peer"]) and not kv.check(["missing"])
    kv.wait(["a"], datetime.timedelta(milliseconds=10))
    with pytest.raises(torch.distributed.DistStoreError):
        kv.wait(["missing"], datetime.timedelta(milliseconds=20))
    assert kv.delete_key("a") and kv.deleted == ["a"]
    assert not kv.check(["a"])


def test_fake_store_barrier_fails_refuses_commit_arrivals():
    kv = FakeKVStore(barrier_fails=True)
    assert kv.add("lgbm_hostgather/t/0/done", 1) == 1   # not a commit
    with pytest.raises(torch.distributed.DistStoreError, match="refused"):
        kv.add("lgbm_gang/commit/1", 1)


# ----------------------------------------------------------- ChaosKVClient

def test_scripted_faults_fire_at_their_call_index():
    kv = FakeKVStore(entries={"k": pickle.dumps({"a": 1})})
    cl = ChaosKVClient(kv, ChaosPlan(seed=1, drop_gets=(1,), delay_gets=(0,),
                                     corrupt_gets=(2,), drop_sets=(0,),
                                     drop_barriers=(0,),
                                     delay_seconds=0.001))
    assert pickle.loads(cl.get("k")) == {"a": 1}            # delayed
    with pytest.raises(KVTimeoutSim):
        cl.get("k")                                         # dropped
    with pytest.raises(Exception):
        pickle.loads(cl.get("k"))                           # corrupted
    with pytest.raises(KVTimeoutSim):
        cl.set("x", b"1")
    cl.set("x", b"1")
    assert cl.add("b", 0) == 0                              # a poll
    with pytest.raises(KVTimeoutSim):
        cl.add("b", 1)                                      # an arrival
    assert cl.add("b", 1) == 1
    assert [e[0] for e in cl.events] == ["delay", "drop", "corrupt", "drop",
                                         "drop"]


def test_seeded_soak_replays():
    def run():
        kv = FakeKVStore(entries={"k": b"v"})
        cl = ChaosKVClient(kv, ChaosPlan(seed=7, kv_drop_prob=0.3,
                                         kv_delay_prob=0.2,
                                         delay_seconds=0.0))
        out = []
        for _ in range(30):
            try:
                cl.get("k")
                out.append("ok")
            except KVTimeoutSim:
                out.append("drop")
        return out, cl.events
    assert run() == run()


@pytest.mark.parametrize("seed", [0, 3, 99])
def test_corrupt_payload_is_the_jax_packages(seed):
    raw = pickle.dumps({"x": list(range(50)), "tag": "binmappers"})
    assert tchaos.corrupt_payload(raw, seed) == \
        jchaos.corrupt_payload(raw, seed)
    assert tchaos.corrupt_payload(b"") == jchaos.corrupt_payload(b"")


def test_host_allgather_retries_through_injected_drops():
    """A dropped get is retried (``retry.py``) and the exchange still
    returns every rank's object; the events name the faults."""
    kv = FakeKVStore()
    kv.set("lgbm_hostgather/t/0/1", pickle.dumps("peer"))
    kv.add("lgbm_hostgather/t/0/done", 1)                 # the peer's arrival
    kv.add("lgbm_hostgather/t/0/left", 1)                 # ... and its leave
    cl = ChaosKVClient(kv, ChaosPlan(seed=1, drop_gets=(0,)))
    before = comm._host_allgather_seq[0]
    comm._host_allgather_seq[0] = 0
    try:
        out = comm.host_allgather("mine", "t", timeout_ms=2_000, client=cl,
                                  rank=0, world=2)
    finally:
        comm._host_allgather_seq[0] = before
    assert out == ["mine", "peer"]
    assert ("drop", "get", "lgbm_hostgather/t/0/1") in cl.events


def test_install_kv_chaos_wraps_the_gang_store():
    kv = FakeKVStore()
    gdist.install_gang_override(kv, rank=0, world=2)
    try:
        w = tchaos.install_kv_chaos(ChaosPlan(seed=2, drop_sets=(0,)))
        client, rank, world = gdist.gang_env()
        assert isinstance(client, ChaosKVClient) and client.inner is kv
        assert gdist.gang_env()[0] is client        # one client per store
        with pytest.raises(KVTimeoutSim):
            client.set("x", b"1")
        assert list(w.clients.values()) == [client]
        tchaos.uninstall_kv_chaos()
        assert gdist.gang_env()[0] is kv
    finally:
        gdist.uninstall_gang_override()


def test_a_dropped_gang_commit_is_a_checkpoint_error(tmp_path):
    """Every commit-barrier arrival dropped: the epoch never commits and
    the save fails loudly (never a silent half-epoch)."""
    from lightgbm_tpu_torch.robustness.checkpoint import CheckpointError
    kv = FakeKVStore()
    cl = ChaosKVClient(kv, ChaosPlan(seed=1, drop_barriers=(0, 1, 2, 3)))
    co = gdist.GangCheckpointCoordinator(str(tmp_path), client=cl, rank=0,
                                         world=1, timeout_ms=500)
    with pytest.raises(CheckpointError, match="commit barrier"):
        co.save({"iteration": 1, "config_fingerprint": "f", "config": {},
                 "state": {}})


# -------------------------------------------------- hang, kill, gradients

class _Env:
    def __init__(self, iteration):
        self.iteration = iteration


def test_hang_callback_is_one_shot_and_marker_gated(tmp_path, monkeypatch):
    marker = str(tmp_path / "m")
    monkeypatch.setenv("LGBM_TPU_CHAOS_HANG", "3:0.05")
    monkeypatch.setenv("LGBM_TPU_CHAOS_HANG_MARKER", marker)
    cb = tchaos.maybe_hang_callback()
    assert cb.order == 90 == jchaos.maybe_hang_callback().order
    t = time.perf_counter()
    cb(_Env(0))
    cb(_Env(1))
    assert time.perf_counter() - t < 0.04            # before iteration 3
    cb(_Env(2))
    assert os.path.exists(marker) and time.perf_counter() - t >= 0.05
    t = time.perf_counter()
    cb(_Env(3))
    tchaos.maybe_hang_callback()(_Env(5))             # the marker exists
    assert time.perf_counter() - t < 0.04
    monkeypatch.setenv("LGBM_TPU_CHAOS_HANG", "bad")
    assert tchaos.maybe_hang_callback() is None
    monkeypatch.delenv("LGBM_TPU_CHAOS_HANG")
    assert tchaos.maybe_hang_callback() is None


@pytest.mark.parametrize("mode", ["nan", "inf"])
def test_nan_gradient_fobj_draws_the_jax_packages(mode):
    class DS:
        def get_label(self):
            return np.linspace(0, 1, 200)
    ours = tchaos.nan_gradient_fobj([1, 3], mode=mode, frac=0.1, seed=5)
    theirs = jchaos.nan_gradient_fobj([1, 3], mode=mode, frac=0.1, seed=5)
    for _ in range(4):
        preds = np.zeros(200)
        g1, h1 = ours(preds, DS())
        g2, h2 = theirs(preds, DS())
        np.testing.assert_array_equal(g1, g2)
        np.testing.assert_array_equal(h1, h2)


def test_kill_after_manifests_kills_at_the_nth_manifest(tmp_path):
    d = str(tmp_path)
    p = subprocess.Popen([sys.executable, "-c", "import time; "
                          "time.sleep(60)"])
    t = tchaos.kill_after_manifests(p, d, n=2, poll_s=0.01, timeout_s=30)
    solo = gdist.GangCheckpointCoordinator(d, client=None, rank=0, world=1,
                                           keep_last_n=0)
    payload = {"iteration": 1, "config_fingerprint": "f", "config": {},
               "state": {}}
    solo.save(payload)
    time.sleep(0.1)
    assert p.poll() is None
    solo.save(dict(payload, iteration=2))
    assert p.wait(timeout=10) == -9
    t.join(timeout=5)


def test_retry_exhaustion_names_the_cost():
    kv = FakeKVStore()
    cl = ChaosKVClient(kv, ChaosPlan(seed=1, drop_sets=(0, 1, 2)))
    with pytest.raises(CommRetryError, match="3 attempt"):
        comm.host_allgather("x", "exhaust", timeout_ms=500, client=cl,
                            rank=0, world=2)
