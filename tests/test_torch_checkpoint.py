"""Single-device checkpoint/resume in ``lightgbm_tpu_torch``
(``robustness/checkpoint.py``, ``Booster.save_checkpoint`` / ``resume``,
``train(resume_from=...)`` and ``checkpoint_dir`` + ``checkpoint_interval``),
on the CPU, against the JAX package.

Bars:
- the ``CheckpointManager`` cases of ``tests/test_robustness.py``: ids,
  pruning, the tmp sweep, the CRC envelope, truncation and bit flips,
  legacy files, the lineage walk, a SIGKILL mid-save, ``--verify``;
- the port's ``config_fingerprint`` equals the JAX package's, and the JAX
  package's ``verify_checkpoint`` accepts the port's files; a JAX snapshot
  is refused by the port's ``load`` without importing ``lightgbm_tpu``;
- a resumed run writes model text byte-identical to an uninterrupted one,
  at ``tree_batch`` 1 and 4 and across ingest modes (the captured path's
  emulation is ``test_torch_tree_batch.py``); snapshots land at the JAX
  engine's iterations; DART, another dataset or another config is refused.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.robustness import checkpoint as jax_ck
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.robustness.checkpoint import (
    ENVELOPE_MAGIC, CheckpointError, CheckpointManager, config_fingerprint,
    config_mismatch_fields, fingerprinted_config, verify_checkpoint)
from lightgbm_tpu_torch.utils.log import LightGBMError

# one intra-op thread: the test workers share the machine's cores, and
# a torch pool of one thread per core on every worker oversubscribes
# them many times over (the port's small CPU ops then wait on it)
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _data(n=600, f=6, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    y = (X[:, 0] * 2 + np.sin(X[:, 1] * 3) + 0.1 * rng.randn(n)).astype(
        np.float64)
    return X, y


# bagging on purpose: resume must restore the threefry key and the carried
# bagging mask exactly, or the continued run parts at once
BASE = dict(objective="regression", num_leaves=15, learning_rate=0.1,
            min_data_in_leaf=5, verbose=-1, metric="none", seed=17,
            bagging_fraction=0.8, bagging_freq=1, device="cpu")


# ------------------------------------------------------------- the manager

def _payload(i=0):
    return {"config_fingerprint": "fp", "config": {}, "iteration": i,
            "state": {"iter": i}}


def test_checkpoint_ids_are_monotonic_and_resume_counting(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last_n=0)
    p1 = mgr.save(_payload(1))
    p2 = mgr.save(_payload(2))
    assert os.path.basename(p1) == "ckpt_0000000001.pkl"
    assert os.path.basename(p2) == "ckpt_0000000002.pkl"
    p3 = CheckpointManager(str(tmp_path)).save(_payload(3))
    assert os.path.basename(p3) == "ckpt_0000000003.pkl"
    assert mgr.latest() == p3


def test_keep_last_n_prunes_old_snapshots(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last_n=2)
    for i in range(5):
        mgr.save(_payload(i))
    assert [i for i, _ in mgr.list_checkpoints()] == [4, 5]


def test_save_sweeps_orphaned_tmp_files(tmp_path):
    orphan = tmp_path / "ckpt_0000000009.pkl.tmp.12345"
    orphan.write_bytes(b"half-written")
    CheckpointManager(str(tmp_path)).save(_payload())
    assert not orphan.exists()


def test_truncated_snapshot_fails_loudly(tmp_path):
    path = CheckpointManager(str(tmp_path)).save(_payload())
    raw = open(path, "rb").read()
    with open(path, "wb") as fh:
        fh.write(raw[: len(raw) // 2])
    with pytest.raises(CheckpointError, match="corrupt or truncated"):
        CheckpointManager.load(path)


def test_non_checkpoint_and_missing_fields_rejected(tmp_path):
    p = tmp_path / "ckpt_0000000001.pkl"
    p.write_bytes(pickle.dumps({"something": "else"}))
    with pytest.raises(CheckpointError, match="format_version"):
        CheckpointManager.load(str(p))
    p.write_bytes(pickle.dumps({"format_version": 1, "config": {},
                                "config_fingerprint": "x", "state": {}}))
    with pytest.raises(CheckpointError, match="iteration"):
        CheckpointManager.load(str(p))
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(CheckpointError, match="no checkpoints"):
        CheckpointManager.resolve(str(empty))
    with pytest.raises(CheckpointError, match="does not exist"):
        CheckpointManager.resolve(str(tmp_path / "missing.pkl"))


def test_snapshot_carries_integrity_envelope(tmp_path):
    path = CheckpointManager(str(tmp_path)).save(_payload(3))
    raw = open(path, "rb").read()
    assert raw.startswith(ENVELOPE_MAGIC) and ENVELOPE_MAGIC == b"LGBMCKP2"
    ok, detail = verify_checkpoint(path)
    assert ok and "iteration 3" in detail
    assert CheckpointManager.load(path)["iteration"] == 3


def test_bit_flip_anywhere_in_payload_is_detected(tmp_path):
    path = CheckpointManager(str(tmp_path)).save(_payload(1))
    raw = bytearray(open(path, "rb").read())
    raw[-1] ^= 0x01
    open(path, "wb").write(bytes(raw))
    ok, detail = verify_checkpoint(path)
    assert not ok and "crc32" in detail
    with pytest.raises(CheckpointError, match="integrity check"):
        CheckpointManager.load(path)


def test_legacy_pre_envelope_snapshot_still_loads(tmp_path):
    p = tmp_path / "ckpt_0000000001.pkl"
    p.write_bytes(pickle.dumps(dict(_payload(4), format_version=1)))
    ok, detail = verify_checkpoint(str(p))
    assert ok and "legacy" in detail
    assert CheckpointManager.load(str(p))["iteration"] == 4


def test_latest_verified_walks_back_past_corruption(tmp_path, caplog):
    import logging
    mgr = CheckpointManager(str(tmp_path), keep_last_n=0)
    paths = [mgr.save(_payload(i)) for i in range(3)]
    raw = open(paths[2], "rb").read()
    open(paths[2], "wb").write(raw[: len(raw) // 2])
    raw = bytearray(open(paths[1], "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(paths[1], "wb").write(bytes(raw))
    with caplog.at_level(logging.WARNING, logger="lightgbm_tpu_torch"):
        assert mgr.latest_verified() == paths[0]
    assert len([r for r in caplog.records
                if "failed verification" in r.getMessage()]) == 2
    from lightgbm_tpu_torch import observability as obs
    assert obs.snapshot()["counters"]["fault.checkpoint_corrupt"] >= 2
    assert len(mgr.list_checkpoints()) == 3


def test_latest_verified_refuses_an_all_corrupt_lineage(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    path = mgr.save(_payload(0))
    open(path, "wb").write(b"\x00" * 64)
    with pytest.raises(CheckpointError, match="refusing to silently"):
        mgr.latest_verified()


def test_latest_verified_empty_dir_is_none(tmp_path):
    assert CheckpointManager(str(tmp_path / "nope")).latest_verified() is None


def test_kill9_during_save_leaves_only_a_tmp_and_next_save_sweeps(tmp_path):
    child = textwrap.dedent(f"""
        import os, sys, time
        sys.path.insert(0, {ROOT!r})
        from lightgbm_tpu_torch.robustness.checkpoint import CheckpointManager
        def hang_replace(src, dst):
            print("READY", flush=True)
            time.sleep(60)
        os.replace = hang_replace
        CheckpointManager({str(tmp_path)!r}).save(
            {{"config_fingerprint": "f", "config": {{}}, "iteration": 0,
              "state": {{}}}})
    """)
    proc = subprocess.Popen([sys.executable, "-c", child],
                            stdout=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().strip() == "READY"
        proc.kill()
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
    names = os.listdir(tmp_path)
    assert any(".pkl.tmp." in n for n in names)
    assert not any(n.endswith(".pkl") for n in names)
    mgr = CheckpointManager(str(tmp_path))
    path = mgr.save(_payload(1))
    assert not any(".pkl.tmp." in n for n in os.listdir(tmp_path))
    assert mgr.latest_verified() == path


def test_verify_cli_reports_and_names_the_resume_target(tmp_path, capsys):
    from lightgbm_tpu_torch.robustness.checkpoint import main as verify_main
    mgr = CheckpointManager(str(tmp_path), keep_last_n=0)
    good = mgr.save(_payload(0))
    bad = mgr.save(_payload(1))
    assert verify_main(["--verify", str(tmp_path)]) == 0
    raw = bytearray(open(bad, "rb").read())
    raw[-3] ^= 0xFF
    open(bad, "wb").write(bytes(raw))
    assert verify_main(["--verify", str(tmp_path)]) == 1
    out = capsys.readouterr().out
    assert "CORRUPT" in out and f"resume target: {good}" in out
    open(good, "wb").write(b"junk")
    assert verify_main(["--verify", str(tmp_path)]) == 2


def test_fingerprint_ignores_run_control_but_not_semantics():
    base = Config.from_params(dict(objective="binary", num_leaves=15))
    fp = config_fingerprint(base)
    same = base.replace(num_iterations=999, output_model="elsewhere.txt",
                        checkpoint_dir="/ck", machines="a:1,b:2",
                        tpu_ingest="device")
    assert config_fingerprint(same) == fp
    assert config_fingerprint(base.replace(num_leaves=31)) != fp
    assert config_fingerprint(base.replace(seed=9)) != fp
    diff = config_mismatch_fields(fingerprinted_config(base),
                                  base.replace(num_leaves=31, seed=9))
    assert diff == ["num_leaves", "seed"]


# ------------------------------------------------- across the two packages

@pytest.mark.parametrize("params", [
    {"objective": "binary", "num_leaves": 31},
    {"objective": "regression", "num_leaves": 15, "bagging_fraction": 0.8,
     "bagging_freq": 1, "seed": 17, "nan_policy": "skip_iter"},
    {"objective": "multiclass", "num_class": 3, "tree_batch": 4,
     "max_bin": 511, "linear_tree": True},
    {"objective": "lambdarank", "boosting": "goss", "enable_bundle": False,
     "tpu_ingest": "device", "checkpoint_interval": 5,
     "checkpoint_dir": "ck"},
])
def test_config_fingerprint_equals_jax(params):
    ours = Config.from_params(params)
    ref = lgb.Config.from_params(params)
    assert fingerprinted_config(ours) == jax_ck.fingerprinted_config(ref)
    assert config_fingerprint(ours) == jax_ck.config_fingerprint(ref)


@pytest.fixture(scope="module")
def port_snapshot(tmp_path_factory):
    """A port snapshot of 4 iterations (bagging, a valid set) and the
    booster that wrote it."""
    d = tmp_path_factory.mktemp("port_ck")
    X, y = _data()
    ds = lgt.Dataset(X, label=y)
    bst = lgt.train(dict(BASE, metric="l2"), ds, num_boost_round=4,
                    valid_sets=[lgt.Dataset(X[:100], label=y[:100],
                                            reference=ds)],
                    keep_training_booster=True)
    return bst.save_checkpoint(str(d)), bst


def test_jax_verify_accepts_the_port_snapshot(port_snapshot, capsys):
    path, _ = port_snapshot
    ok, detail = jax_ck.verify_checkpoint(path)
    assert ok and "iteration 4" in detail
    assert jax_ck.main(["--verify", os.path.dirname(path)]) == 0
    payload = jax_ck.CheckpointManager.load(path)
    assert payload["state"]["n_devices"] == 1
    assert payload["state"]["tree_learner"] == "serial"


def test_port_payload_holds_builtins_and_numpy_only(port_snapshot):
    path, bst = port_snapshot
    payload = CheckpointManager.load(path)
    allowed = (dict, list, tuple, str, int, float, bool, bytes,
               type(None), np.ndarray, np.generic)

    def walk(o):
        assert isinstance(o, allowed), type(o)
        if isinstance(o, dict):
            for k, v in o.items():
                walk(k)
                walk(v)
        elif isinstance(o, (list, tuple)):
            for v in o:
                walk(v)
    walk(payload)
    st = payload["state"]
    assert st["iter"] == 4 and len(st["models"]) == 4
    assert st["data_fingerprint"] == bst._gbdt._data_fingerprint
    assert st["rng_key"].dtype == np.uint32
    assert set(st["valid_scores"]) == {"valid_0"}


def test_jax_snapshot_refused_without_importing_lightgbm_tpu(tmp_path):
    X, y = _data(n=300)
    p = {k: v for k, v in BASE.items() if k != "device"}
    lgb.train(dict(p, checkpoint_dir=str(tmp_path), checkpoint_interval=2),
              lgb.Dataset(X, label=y), num_boost_round=2)
    child = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {ROOT!r})
        from lightgbm_tpu_torch.robustness.checkpoint import (
            CheckpointError, CheckpointManager)
        try:
            CheckpointManager.load({str(tmp_path)!r})
            print("LOADED")
        except CheckpointError as e:
            print("REFUSED", e)
        print("IMPORTED", any(m == "lightgbm_tpu" or
                              m.startswith("lightgbm_tpu.")
                              for m in sys.modules))
    """)
    out = subprocess.run([sys.executable, "-c", child], capture_output=True,
                         text=True, timeout=120).stdout
    assert "REFUSED" in out and "JAX package (lightgbm_tpu)" in out, out
    assert "IMPORTED False" in out, out


# ------------------------------------------------------ resume identity

@pytest.mark.parametrize("tree_batch", [1, 4])
def test_kill_and_resume_bit_identical(tmp_path, tree_batch):
    """A run stopped after 5 iterations and restarted with the same command
    (``resume_from="auto"``) from the interval-2 snapshot writes the
    uninterrupted run's model text."""
    X, y = _data()
    params = dict(BASE, tree_batch=tree_batch)
    straight = lgt.train(params, lgt.Dataset(X, label=y),
                         num_boost_round=8).model_to_string()
    ck = dict(params, checkpoint_dir=str(tmp_path), checkpoint_interval=2)
    lgt.train(ck, lgt.Dataset(X, label=y), num_boost_round=5)
    resumed = lgt.train(ck, lgt.Dataset(X, label=y), num_boost_round=8,
                        resume_from="auto")
    assert resumed.num_trees() == 8
    assert resumed.model_to_string() == straight


def test_booster_resume_with_valid_set_and_eval_history(port_snapshot):
    """``Booster.resume`` on a fresh booster: the valid scores, eval
    history and trees come back, and training on matches the booster that
    wrote the snapshot."""
    path, bst = port_snapshot
    X, y = _data()
    ds = lgt.Dataset(X, label=y)
    fresh = lgt.Booster(params=dict(BASE, metric="l2"), train_set=ds)
    fresh.add_valid(lgt.Dataset(X[:100], label=y[:100], reference=ds),
                    "valid_0")
    fresh.resume(path)
    assert fresh.eval_history == {
        k: dict(v) for k, v in bst.eval_history.items()}
    assert fresh.model_to_string() == bst.model_to_string()
    assert torch.equal(fresh._gbdt.valid_sets[0].score,
                       bst._gbdt.valid_sets[0].score)
    for b in (bst, fresh):
        for _ in range(2):
            b.update()
    assert fresh.model_to_string() == bst.model_to_string()
    assert fresh.eval_valid() == bst.eval_valid()


def test_checkpoint_resume_across_ingest_modes(tmp_path):
    """``tpu_ingest`` is checkpoint-volatile: a snapshot trained under
    device ingest resumes under host ingest, bit-identically."""
    X = _data(n=2500)[0]
    X[:, 1] = np.round(X[:, 1] * 4) / 4
    y = (X[:, 0] > 0).astype(np.float32)
    p = dict(BASE, objective="binary", tpu_ingest="device")
    bd = lgt.train(p, lgt.Dataset(X.copy(), label=y.copy(), params=p),
                   num_boost_round=4, keep_training_booster=True)
    assert bd._gbdt._ingest_report is not None
    bd.save_checkpoint(str(tmp_path))
    ph = dict(p, tpu_ingest="host")
    bh = lgt.Booster(params=ph, train_set=lgt.Dataset(X.copy(),
                                                      label=y.copy(),
                                                      params=ph))
    assert bh._gbdt._ingest_report is None
    bh.resume(str(tmp_path))
    for _ in range(3):
        bd.update()
        bh.update()
    np.testing.assert_array_equal(bd.predict(X), bh.predict(X))
    assert bd.model_to_string() == bh.model_to_string()


@pytest.mark.parametrize("tree_batch,interval", [(1, 2), (4, 3), (3, 2)])
def test_snapshot_iterations_equal_jax_engine(tmp_path, tree_batch,
                                              interval):
    X, y = _data(n=400)
    iters = []
    for pkg, mgr_cls in ((lgt, CheckpointManager),
                         (lgb, jax_ck.CheckpointManager)):
        d = tmp_path / pkg.__name__
        p = dict(BASE, tree_batch=tree_batch, checkpoint_dir=str(d),
                 checkpoint_interval=interval, checkpoint_keep_last_n=0)
        if pkg is lgb:
            p.pop("device")
        pkg.train(p, pkg.Dataset(X, label=y), num_boost_round=10)
        mgr = mgr_cls(str(d))
        iters.append([jax_ck.CheckpointManager._validate_payload(
            jax_ck.CheckpointManager._read_payload_bytes(path)[0],
            path)["iteration"] for _, path in mgr.list_checkpoints()])
    assert iters[0] == iters[1] and len(iters[0]) >= 2


# ------------------------------------------------------------- refusals

def test_resume_from_auto_starts_fresh_without_checkpoints(tmp_path):
    X, y = _data(n=300)
    ck = dict(BASE, checkpoint_dir=str(tmp_path / "empty"))
    bst = lgt.train(ck, lgt.Dataset(X, label=y), num_boost_round=3,
                    resume_from="auto")
    assert bst.num_trees() == 3


def test_resume_rejects_different_dataset_of_same_shape(tmp_path):
    X, y = _data(n=300)
    ck = dict(BASE, checkpoint_dir=str(tmp_path), checkpoint_interval=2)
    lgt.train(ck, lgt.Dataset(X, label=y), num_boost_round=2)
    X2, y2 = _data(n=300, seed=99)
    with pytest.raises(LightGBMError, match="dataset mismatch"):
        lgt.train(ck, lgt.Dataset(X2, label=y2), num_boost_round=4,
                  resume_from="auto")


def test_resume_rejects_semantic_config_change(tmp_path):
    X, y = _data(n=300)
    ck = dict(BASE, checkpoint_dir=str(tmp_path), checkpoint_interval=2)
    lgt.train(ck, lgt.Dataset(X, label=y), num_boost_round=2)
    with pytest.raises(CheckpointError, match="num_leaves"):
        lgt.train(dict(ck, num_leaves=31), lgt.Dataset(X, label=y),
                  num_boost_round=4, resume_from="auto")


def test_dart_refused():
    with pytest.raises(LightGBMError, match="dart"):
        Config.from_params(dict(boosting="dart", checkpoint_dir="/ck"))
    with pytest.raises(LightGBMError, match="dart"):
        Config.from_params(dict(boosting="dart", resume_from="auto"))
    X, y = _data(n=300)
    bst = lgt.Booster(params=dict(BASE, boosting="dart"),
                      train_set=lgt.Dataset(X, label=y))
    bst.update()
    with pytest.raises(LightGBMError, match="dart"):
        bst.save_checkpoint("unused")
    with pytest.raises(LightGBMError, match="dart"):
        bst.resume("unused")


@pytest.mark.parametrize("field,value,match", [
    ("n_devices", 4, "mesh mismatch"),
    ("tree_learner", "data", "learner mismatch"),
    ("num_data", 7, "num_data"),
])
def test_restore_refuses_other_meshes_and_shapes(port_snapshot, field,
                                                 value, match):
    path, bst = port_snapshot
    state = dict(CheckpointManager.load(path)["state"], **{field: value})
    with pytest.raises(LightGBMError, match=match):
        bst._gbdt.restore_checkpoint_state(state)
