"""Deterministic fault injection for the robustness layer.

Port of ``lightgbm_tpu/robustness/chaos.py``. Every degradation path the
port claims to survive is exercisable on the CPU, without a real cluster:

- ``FakeKVStore``    — an in-process key-value store with the
  ``torch.distributed`` ``Store`` API that ``parallel/comm.host_allgather``,
  the gang checkpoint protocol and the heartbeat leases use (``set``,
  ``get``, ``wait``, ``add``, ``check``, ``delete_key``), backed by a
  ``torch.distributed.HashStore``: thread-per-rank tests run a whole gang on
  one. It records the keys it deleted, can be preloaded with peers' keys,
  and with ``barrier_fails`` refuses every commit-barrier arrival.
- ``ChaosKVClient``  — wraps any store (fake or the world's ``TCPStore``)
  and injects delays, drops (raised errors) and corrupted payloads. Faults
  fire at explicit 0-based call indices per operation (``delay_gets=(0,
  2)``: exact scripts for tests) or under a seeded RNG (``*_prob``: soak
  mode); both replay for a fixed seed. Injected events are on ``.events``.
  The torch store has no barrier: a barrier arrival is an ``add`` of a
  positive amount, and ``drop_barriers`` counts those.
- ``install_kv_chaos`` / ``uninstall_kv_chaos`` — route every store the
  package obtains through a ``ChaosKVClient`` (``parallel.comm``'s store
  wrapper), so a live world is faulted without touching call sites.
- ``kill_after_checkpoints`` / ``kill_after_manifests`` — SIGKILL a child
  once a directory holds ``n`` snapshots or gang manifests (a watcher from
  outside; on the card ten captured rounds take about 0.3 s, too short a
  window to poll, so ``chip_smoke.py``'s children kill themselves from a
  callback instead).
- ``corrupt_host_shard`` / ``maybe_corrupt_shard_from_env`` — a bit flip in
  a host code shard, which the per-shard CRC32 (``ops/stream.py``) must
  catch (``LGBM_TPU_CHAOS_FLIP_SHARD=<marker>``).
- ``maybe_hang_callback`` — ``LGBM_TPU_CHAOS_HANG=<iteration>:<seconds>``
  parks the loop after an iteration, where the watchdog's heartbeat goes
  quiet (``LGBM_TPU_CHAOS_HANG_MARKER=<path>`` makes it one-shot across
  supervisor restarts).
- ``nan_gradient_fobj`` — a custom objective that poisons chosen
  iterations' gradients, driving every ``nan_policy`` branch.

The default seed comes from ``LGBM_TPU_CHAOS_SEED``, so a failing chaos run
replays bit for bit.
"""
from __future__ import annotations

import datetime
import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils.log import Log

ENV_FLIP_SHARD = "LGBM_TPU_CHAOS_FLIP_SHARD"    # marker-file path
ENV_HANG = "LGBM_TPU_CHAOS_HANG"                # "<iteration>:<seconds>"
ENV_HANG_MARKER = "LGBM_TPU_CHAOS_HANG_MARKER"  # marker-file path


def default_seed() -> int:
    try:
        return int(os.environ.get("LGBM_TPU_CHAOS_SEED", "1234"))
    except ValueError:
        return 1234


class ChaosInjectedError(RuntimeError):
    """A deliberately injected fault (distinguishable from real failures)."""


class KVTimeoutSim(ChaosInjectedError):
    """A simulated store timeout (a dropped key-value exchange)."""


@dataclass
class ChaosPlan:
    """What to inject, and when. Explicit index tuples are 0-based call
    counts per operation kind; the probabilistic knobs draw from an RNG
    seeded with ``seed``, so a plan replays identically."""
    seed: int = field(default_factory=default_seed)
    # explicit, scripted faults (exact call indices)
    delay_gets: Tuple[int, ...] = ()
    drop_gets: Tuple[int, ...] = ()
    corrupt_gets: Tuple[int, ...] = ()
    drop_sets: Tuple[int, ...] = ()
    drop_barriers: Tuple[int, ...] = ()
    # probabilistic soak mode
    kv_delay_prob: float = 0.0
    kv_drop_prob: float = 0.0
    kv_corrupt_prob: float = 0.0
    delay_seconds: float = 0.01


class ChaosKVClient:
    """A ``torch.distributed`` store wrapper injecting faults per
    :class:`ChaosPlan`."""

    def __init__(self, inner, plan: Optional[ChaosPlan] = None):
        self.inner = inner
        self.plan = plan or ChaosPlan()
        self._rng = random.Random(self.plan.seed)
        self._calls = {"set": 0, "get": 0, "barrier": 0}
        self.events: List[Tuple[str, str, str]] = []   # (fault, op, key)

    def _record(self, fault: str, op: str, key: str) -> None:
        self.events.append((fault, op, key))
        Log.debug("chaos: injected %s on %s %s", fault, op, key)

    def _fault(self, op: str, key: str, scripted_drop: Sequence[int],
               scripted_delay: Sequence[int] = ()) -> None:
        i = self._calls[op]
        self._calls[op] += 1
        if i in scripted_delay or self._rng.random() < self.plan.kv_delay_prob:
            self._record("delay", op, key)
            time.sleep(self.plan.delay_seconds)
        if i in scripted_drop or self._rng.random() < self.plan.kv_drop_prob:
            self._record("drop", op, key)
            raise KVTimeoutSim(
                f"chaos: injected {op} drop for key {key!r} (call #{i})")

    # ---- the Store surface the package calls -------------------------

    def set(self, key: str, value) -> None:
        self._fault("set", key, self.plan.drop_sets)
        self.inner.set(key, value)

    def get(self, key: str) -> bytes:
        i = self._calls["get"]         # _fault advances the counter
        self._fault("get", key, self.plan.drop_gets, self.plan.delay_gets)
        raw = self.inner.get(key)
        if (i in self.plan.corrupt_gets
                or self._rng.random() < self.plan.kv_corrupt_prob):
            self._record("corrupt", "get", key)
            raw = corrupt_payload(raw, seed=self.plan.seed + i)
        return raw

    def add(self, key: str, amount: int) -> int:
        if amount > 0:                 # a barrier arrival
            self._fault("barrier", key, self.plan.drop_barriers)
        return self.inner.add(key, amount)

    def wait(self, keys, timeout=None):
        if timeout is None:
            return self.inner.wait(keys)
        return self.inner.wait(keys, timeout)

    def check(self, keys) -> bool:
        return self.inner.check(keys)

    def delete_key(self, key: str) -> bool:
        return self.inner.delete_key(key)


def corrupt_payload(raw: bytes, seed: int = 0) -> bytes:
    """Flip bytes of a pickled payload deterministically so that unpickling
    (or the schema check) fails: a bit-rotted store value."""
    if not raw:
        return b"\x80"                           # truncated pickle opcode
    rng = random.Random(seed)
    buf = bytearray(raw)
    for _ in range(max(1, len(buf) // 16)):
        pos = rng.randrange(len(buf))
        buf[pos] ^= 0xFF
    # also chop the tail: pickle.loads must not luck into success
    return bytes(buf[: max(1, len(buf) - 2)])


class FakeKVStore:
    """In-process ``torch.distributed`` store double over a ``HashStore``.

    ``preload(key, value)`` (or ``entries=``) sets peers' keys before a
    single-threaded test runs; ``get`` blocks until its key appears or the
    store's timeout passes, and ``wait`` until its keys appear or the given
    timeout passes, raising the ``DistStoreError`` a real store raises.
    ``barrier_fails=True`` refuses every arrival (``add`` of a positive
    amount) on a gang commit barrier: a peer that never persisted its
    epoch. ``deleted`` records the deleted keys."""

    def __init__(self, entries=None, barrier_fails: bool = False,
                 timeout_s: float = 30.0):
        import torch.distributed as dist
        self.inner = dist.HashStore()
        self.inner.set_timeout(datetime.timedelta(seconds=timeout_s))
        self.barrier_fails = barrier_fails
        self.deleted: List[str] = []
        for k, v in (entries or {}).items():
            self.inner.set(k, v)

    def preload(self, key: str, value) -> "FakeKVStore":
        self.inner.set(key, value)
        return self

    def set(self, key: str, value) -> None:
        self.inner.set(key, value)

    def get(self, key: str) -> bytes:
        return self.inner.get(key)

    def add(self, key: str, amount: int) -> int:
        if self.barrier_fails and amount > 0 and "/commit/" in key:
            import torch.distributed as dist
            raise dist.DistStoreError(
                f"FakeKVStore: barrier {key!r} refused (barrier_fails)")
        return self.inner.add(key, amount)

    def wait(self, keys, timeout=None):
        if timeout is None:
            return self.inner.wait(keys)
        return self.inner.wait(keys, timeout)

    def check(self, keys) -> bool:
        return self.inner.check(keys)

    def delete_key(self, key: str) -> bool:
        self.deleted.append(key)
        return self.inner.delete_key(key)


# ------------------------------------------------------ live-cluster hook

def install_kv_chaos(plan: Optional[ChaosPlan] = None):
    """Route every store ``parallel.comm`` hands out through a
    :class:`ChaosKVClient` (one per underlying store, so the fault call
    counters carry across calls). Returns the wrapper; its ``.clients``
    holds the live clients (for their ``.events``). Undo with
    :func:`uninstall_kv_chaos`."""
    from ..parallel import comm

    wrapped = {}

    def wrapper(inner):
        cl = wrapped.get(id(inner))
        if cl is None:
            cl = wrapped[id(inner)] = ChaosKVClient(inner, plan)
        return cl

    wrapper.clients = wrapped
    comm._client_wrapper = wrapper
    return wrapper


def uninstall_kv_chaos() -> None:
    from ..parallel import comm
    comm._client_wrapper = None


# --------------------------------------------------------- killers

def _killer(proc, done, what: str, timeout_s: float, poll_s: float,
            name: str):
    def _run():
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline and proc.poll() is None:
            if done():
                Log.debug("chaos: SIGKILLing pid %s at %s",
                          getattr(proc, "pid", "?"), what)
                proc.kill()
                return
            time.sleep(poll_s)

    t = threading.Thread(target=_run, name=name, daemon=True)
    t.start()
    return t


def kill_after_checkpoints(proc, ckpt_dir: str, n: int = 2,
                           timeout_s: float = 300.0, poll_s: float = 0.05):
    """A daemon thread that SIGKILLs ``proc`` once ``ckpt_dir`` holds at
    least ``n`` snapshots (a preemption mid-run). Returns the thread; it
    ends quietly when the process finishes first or the deadline passes."""
    from .checkpoint import CheckpointManager
    mgr = CheckpointManager(ckpt_dir)
    return _killer(proc, lambda: len(mgr.list_checkpoints()) >= n,
                   f"{n} checkpoints", timeout_s, poll_s,
                   "lgbm-chaos-killer")


def kill_after_manifests(proc, ckpt_dir: str, n: int = 2,
                         timeout_s: float = 300.0, poll_s: float = 0.05):
    """The gang sibling of :func:`kill_after_checkpoints`: SIGKILL ``proc``
    once ``ckpt_dir`` holds ``n`` committed epoch manifests (one rank dies
    after the gang banked consistent state)."""
    from .distributed import list_manifests
    return _killer(proc, lambda: len(list_manifests(ckpt_dir)) >= n,
                   f"{n} gang manifests", timeout_s, poll_s,
                   "lgbm-chaos-gang-killer")


# ----------------------------------------------------- shard/hang injection

def corrupt_host_shard(store, shard_index: int = 0,
                       seed: Optional[int] = None, n_bytes: int = 4) -> int:
    """Flip ``n_bytes`` bytes of one packed shard of a ``HostShardStore``
    in place (host memory rotting under a live run). Deterministic under
    ``seed``; returns the shard index."""
    rng = random.Random(default_seed() if seed is None else seed)
    flat = store.shards[shard_index].reshape(-1)
    for _ in range(max(1, n_bytes)):
        flat[rng.randrange(flat.size)] ^= 0xFF
    Log.debug("chaos: bit-flipped %d byte(s) of host shard %d",
              max(1, n_bytes), shard_index)
    return shard_index


def maybe_corrupt_shard_from_env(store) -> bool:
    """``LGBM_TPU_CHAOS_FLIP_SHARD=<marker path>`` flips shard 0 right after
    the store is built unless the marker file exists (and creates it), so
    only the first of a supervised run's processes is poisoned. Returns
    True when the fault fired; a no-op without the variable."""
    marker = os.environ.get(ENV_FLIP_SHARD, "")
    if not marker or os.path.exists(marker):
        return False
    with open(marker, "w") as fh:
        fh.write("shard-corruption injected\n")
    corrupt_host_shard(store)
    Log.warning("chaos: injected stream-shard corruption (marker %s)",
                marker)
    return True


def maybe_hang_callback():
    """``LGBM_TPU_CHAOS_HANG=<iteration>:<seconds>`` returns an
    after-iteration callback that sleeps ``seconds`` at the first boundary
    past ``iteration`` (a stand-in for a wedged collective, parked where
    the watchdog's heartbeat goes quiet). ``LGBM_TPU_CHAOS_HANG_MARKER=
    <path>`` makes it one-shot across supervisor restarts. None without
    the variable."""
    spec = os.environ.get(ENV_HANG, "")
    if not spec:
        return None
    try:
        it_s, sec_s = spec.split(":", 1)
        hang_iter, hang_seconds = int(it_s), float(sec_s)
    except ValueError:
        Log.warning("chaos: malformed %s=%r (want '<iteration>:<seconds>')"
                    " — hang injection disabled", ENV_HANG, spec)
        return None
    marker = os.environ.get(ENV_HANG_MARKER, "")
    state = {"fired": False}

    def _hang(env):
        if state["fired"] or env.iteration + 1 < hang_iter:
            return
        state["fired"] = True
        if marker:
            if os.path.exists(marker):
                return
            with open(marker, "w") as fh:
                fh.write("hang injected\n")
        Log.warning("chaos: injected %.1fs hang at iteration %d (the "
                    "watchdog should fire)", hang_seconds, env.iteration + 1)
        time.sleep(hang_seconds)

    _hang.order = 90            # after every real callback: the boundary
    return _hang                # work is done before the loop wedges


# --------------------------------------------------------------- gradients

def nan_gradient_fobj(bad_iters: Sequence[int], mode: str = "nan",
                      frac: float = 0.05, seed: Optional[int] = None):
    """A ``fobj(preds, train_data) -> (grad, hess)`` for squared loss that
    poisons ``frac`` of the gradients with NaN (or +Inf, ``mode="inf"``) at
    the chosen 0-based iterations: the forced-NaN leg of every
    ``nan_policy`` branch. The JAX package's draws, for the same seed."""
    bad = set(int(i) for i in bad_iters)
    rng = np.random.RandomState(default_seed() if seed is None else seed)
    poison = np.nan if mode == "nan" else np.inf
    state = {"it": 0}

    def fobj(preds, train_data):
        y = np.asarray(train_data.get_label(), np.float32)
        preds = np.asarray(preds, np.float32).reshape(y.shape)
        grad = preds - y
        hess = np.ones_like(grad)
        if state["it"] in bad:
            k = max(1, int(len(grad) * frac))
            idx = rng.choice(len(grad), size=k, replace=False)
            grad = grad.copy()
            grad[idx] = poison
            Log.debug("chaos: poisoned %d gradients with %s at iteration %d",
                      k, poison, state["it"])
        state["it"] += 1
        return grad, hess

    return fobj
