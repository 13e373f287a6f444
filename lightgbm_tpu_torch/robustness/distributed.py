"""Distributed fault tolerance: gang-consistent checkpoints, heartbeat
leases, peer-loss detection and elastic resume, on ``torch.distributed``.

Port of ``lightgbm_tpu/robustness/distributed.py``. A world of ranks (one
process each, ``parallel/comm.py``) breaks the one-writer checkpoint loop
in three ways this module closes:

1. **Torn checkpoints.** Every rank writes its own shard snapshot, the
   shards' CRCs are exchanged through the world's key-value store, and
   rank 0 publishes an **epoch manifest** (iteration, world, per-rank
   CRCs) that every rank persists before a commit barrier. An epoch either
   has a manifest every rank persisted, or it does not exist.
2. **Mixed-iteration resume.** ``resume_from=auto`` takes the newest
   manifest every rank verifies locally (manifest present, own shard
   present, CRC matches): the verified sets are all-gathered and
   intersected, so a rank missing its shard drags the whole gang back one
   epoch together.
3. **Hangs instead of named failures.** Each rank beats a **heartbeat
   lease** (a sequence number) in the store at the engine's batch
   boundaries; peers judge its age by their own clock. A probe before each
   batch raises ``PeerLostError`` naming a rank whose lease expired; for a
   peer that dies inside a collective, the hang watchdog's attribution hook
   reads the same leases, and :func:`comm_loss_error` maps what the dead
   collective raised (gloo's ``RuntimeError`` on a reset pair, the store's
   ``DistNetworkError``) onto the typed errors: the command line exits 145.

The store is the torch ``Store`` (``set``, ``get``, ``wait``, ``add``,
``check``, ``delete_key``): rank 0 hosts the world's ``TCPStore``
(``parallel/comm.init_distributed``), so when rank 0 dies every store call
of a survivor fails at once and is mapped to ``PeerLostError`` naming rank
0 (``parallel.comm.store_loss_error``). The store has no barrier; the
commit barrier is an ``add`` per arrival and a poll of the count
(``parallel.comm.arrive_and_wait``), probing the active lease between
polls, and rank 0 leaves it last (``parallel.comm.leave_last``). Everything here runs on the host at batch boundaries: no device
read, nothing inside a captured graph.

Manifest protocol (one ``save()``)::

    rank 0                     rank 1..W-1
    write shard_E_r0000.pkl    write shard_E_rNNNN.pkl
        \\_____ allgather (rank, file, crc, size, iteration) _____/
    build manifest JSON
    store set manifest/E ----> store wait + get manifest/E
    persist manifest_E.json    persist manifest_E.json
        \\______________ commit barrier E ________________________/

The manifest JSON has the JAX package's keys and ``MANIFEST_VERSION`` 1,
and the shards the ``LGBMCKP2`` envelope of ``robustness/checkpoint.py``:
the JAX package's ``verify_manifest`` and ``audit_manifest_dir`` accept a
port's gang directory. A manifest records the world it was written under;
resuming under another world size is refused unless ``elastic=true`` (the
fleet supervisor's shrink path, with ``tpu_reshard_on_resume=true`` for
the booster's re-layout of the row blocks).

Everything takes an explicit ``client`` / ``rank`` / ``world``, so the
chaos doubles (``robustness/chaos.FakeKVStore``, ``ChaosKVClient``) drive
the whole protocol in one process; :func:`gang_env` resolves the live
world for the booster and the engine.
"""
from __future__ import annotations

import datetime
import json
import os
import pickle
import re
import time
import zlib
from typing import Callable, Dict, List, Optional, Tuple

from ..utils.log import Log
from .checkpoint import (ENVELOPE_MAGIC, _ENVELOPE, CheckpointError,
                         FORMAT_VERSION, _fsync_dir, verify_checkpoint)
from .retry import CommRetryError, PeerLostError, retry_call

MANIFEST_VERSION = 1

_SHARD_RE = re.compile(r"^shard_(\d{10})_r(\d{4})\.pkl$")
_MANIFEST_RE = re.compile(r"^manifest_(\d{10})\.json$")

_KV_PREFIX = "lgbm_gang"


# --------------------------------------------------------------- gang wiring

# test override: (client, rank, world), so thread-per-rank tests drive the
# booster's gang path over an in-process store
_gang_override: Optional[Tuple[object, int, int]] = None
# the lease the engine armed for this run (None: none), which the commit
# barrier probes while it waits
_active_lease: Optional["HeartbeatLease"] = None


def install_gang_override(client, rank: int = 0, world: int = 1) -> None:
    """Make :func:`gang_env` report a gang backed by ``client`` (a store).
    Undo with :func:`uninstall_gang_override`."""
    global _gang_override
    _gang_override = (client, int(rank), int(world))


def uninstall_gang_override() -> None:
    global _gang_override
    _gang_override = None


def gang_env() -> Optional[Tuple[object, int, int]]:
    """``(store, rank, world)`` when the gang protocol should engage — a
    live world of more than one process (its store is
    ``parallel.comm.distributed_store()``) or an installed override — else
    None (single-process semantics). The store goes through the
    fault-injection wrapper, as ``host_allgather``'s does."""
    from ..parallel import comm
    if _gang_override is not None:
        client, rank, world = _gang_override
        return comm.wrap_store(client), rank, world
    rank, world = comm.world_rank_and_size()
    if world <= 1:
        return None
    client = comm.distributed_store()
    if client is None:
        return None
    return client, rank, world


def set_active_lease(lease: Optional["HeartbeatLease"]) -> None:
    global _active_lease
    _active_lease = lease


# ----------------------------------------------------------- shard envelopes

def write_shard_file(path: str, payload: Dict) -> Tuple[int, int]:
    """Atomically write one rank's shard snapshot in the checkpoint
    envelope (magic | crc32 | length | pickle). Returns ``(crc32, size)``
    of the payload bytes, which the manifest records."""
    raw = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
    crc = zlib.crc32(raw) & 0xFFFFFFFF
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as fh:
            fh.write(_ENVELOPE.pack(ENVELOPE_MAGIC, crc, len(raw)))
            fh.write(raw)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
        _fsync_dir(os.path.dirname(path) or ".")
    except OSError as e:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise CheckpointError(f"cannot write gang shard {path}: {e}") from e
    return crc, len(raw)


def envelope_crc(path: str) -> Optional[int]:
    """The crc32 in a snapshot file's envelope header (None for a missing,
    short or envelope-less file)."""
    try:
        with open(path, "rb") as fh:
            head = fh.read(_ENVELOPE.size)
    except OSError:
        return None
    if len(head) < _ENVELOPE.size or not head.startswith(ENVELOPE_MAGIC):
        return None
    _magic, crc, _length = _ENVELOPE.unpack(head)
    return crc


def _write_bytes_atomic(path: str, raw: bytes, discriminator: str = "") -> None:
    # the discriminator keeps concurrent writers of the same target apart
    # (ranks sharing one directory, and one pid in thread-per-rank tests,
    # each persist the identical manifest bytes; the last rename wins)
    tmp = f"{path}.tmp.{os.getpid()}{discriminator}"
    with open(tmp, "wb") as fh:
        fh.write(raw)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path) or ".")


# ------------------------------------------------------------ manifest audit
# file, JSON and CRC checks only, so `checkpoint --verify` audits a gang
# directory from the shell

def list_manifests(directory: str) -> List[Tuple[int, str]]:
    """``[(epoch, manifest_path)]`` ascending; empty for a non-gang dir."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = _MANIFEST_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, name)))
    out.sort()
    return out


def load_manifest(path: str) -> Dict:
    """Parse and schema-check one epoch manifest; raises CheckpointError."""
    try:
        with open(path, "rb") as fh:
            manifest = json.loads(fh.read().decode("utf-8"))
    except (OSError, ValueError, UnicodeDecodeError) as e:
        raise CheckpointError(
            f"cannot parse gang manifest {path}: {type(e).__name__}: {e}") \
            from e
    if not isinstance(manifest, dict) or "shards" not in manifest:
        raise CheckpointError(f"{path} is not a gang manifest (no shards)")
    if manifest.get("manifest_version") != MANIFEST_VERSION:
        raise CheckpointError(
            f"{path} has manifest_version="
            f"{manifest.get('manifest_version')}; this build reads version "
            f"{MANIFEST_VERSION}")
    return manifest


def verify_manifest(path: str, directory: Optional[str] = None,
                    only_rank: Optional[int] = None) -> Tuple[bool, str]:
    """Check one manifest against the shard files: every listed shard (or
    ``only_rank``'s) exists, carries the recorded crc32 in its envelope and
    passes the full snapshot check. ``(ok, detail)``; never raises."""
    directory = directory or os.path.dirname(path) or "."
    try:
        manifest = load_manifest(path)
    except CheckpointError as e:
        return False, str(e)
    problems = []
    checked = 0
    for shard in manifest.get("shards", []):
        rank = shard.get("rank")
        if only_rank is not None and rank != only_rank:
            continue
        checked += 1
        spath = os.path.join(directory, shard.get("file", ""))
        if not os.path.isfile(spath):
            problems.append(f"rank {rank} shard {shard.get('file')} missing")
            continue
        crc = envelope_crc(spath)
        if crc != shard.get("crc32"):
            problems.append(
                f"rank {rank} shard {shard.get('file')} crc32 "
                f"{'<none>' if crc is None else f'{crc:#010x}'} != manifest "
                f"{shard.get('crc32', 0):#010x}")
            continue
        ok, det = verify_checkpoint(spath)
        if not ok:
            problems.append(f"rank {rank} shard {shard.get('file')}: {det}")
    if only_rank is not None and checked == 0:
        problems.append(f"manifest lists no shard for rank {only_rank}")
    if problems:
        return False, "; ".join(problems)
    return True, (f"epoch {manifest.get('epoch')}, iteration "
                  f"{manifest.get('iteration')}, world "
                  f"{manifest.get('world')}, {checked} shard(s) verified")


def audit_manifest_dir(directory: str) -> List[Tuple[int, str, bool, str]]:
    """``[(epoch, manifest_path, ok, detail)]`` ascending by epoch."""
    return [(epoch, path, *verify_manifest(path, directory))
            for epoch, path in list_manifests(directory)]


# -------------------------------------------------------- gang checkpointing

class GangCheckpointCoordinator:
    """The gang save / resolve protocol over one checkpoint directory.
    ``client`` is the world's store (None: solo, no exchanges and local
    resolution only — how a shrunk or single-process resume reads a gang
    directory). ``lease`` (default: the engine's active lease) is probed
    while the commit barrier waits, so a peer that died before arriving
    raises ``PeerLostError`` at the lease timeout, not the barrier's."""

    def __init__(self, directory: str, *, client=None, rank: int = 0,
                 world: int = 1, keep_last_n: int = 3,
                 timeout_ms: int = 600_000, elastic: bool = False,
                 lease: Optional["HeartbeatLease"] = None):
        if not directory:
            raise CheckpointError("checkpoint_dir is empty — set "
                                  "checkpoint_dir=...")
        self.directory = directory
        self.client = client
        self.rank = int(rank)
        self.world = int(world)
        self.keep_last_n = int(keep_last_n)
        self.timeout_ms = int(timeout_ms)
        self.elastic = bool(elastic)
        self.lease = lease
        # host seconds of the last save: shard write, exchange and manifest
        # publish, and the commit barrier (chip_smoke.py reads them)
        self.timings: Dict[str, float] = {}

    # ------------------------------------------------------------- plumbing

    def _allgather(self, obj, tag: str):
        """Rank-ordered host allgather over the gang's store (retries,
        timeouts and store-loss mapping in ``host_allgather``)."""
        if self.world <= 1 or self.client is None:
            return [obj]
        from ..parallel import comm
        return comm.host_allgather(obj, tag, timeout_ms=self.timeout_ms,
                                   client=self.client, rank=self.rank,
                                   world=self.world)

    def shard_name(self, epoch: int, rank: Optional[int] = None) -> str:
        return f"shard_{epoch:010d}_r{(self.rank if rank is None else rank):04d}.pkl"

    def manifest_path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"manifest_{epoch:010d}.json")

    def _local_epochs(self) -> List[int]:
        epochs = {e for e, _ in list_manifests(self.directory)}
        if os.path.isdir(self.directory):
            for name in os.listdir(self.directory):
                m = _SHARD_RE.match(name)
                if m:
                    epochs.add(int(m.group(1)))
        return sorted(epochs)

    def _store_call(self, fn, what: str):
        """``fn()`` through ``retry_call``; a store whose host is gone
        becomes ``PeerLostError`` naming it."""
        from ..parallel import comm
        try:
            return retry_call(fn, what=what)
        except Exception as e:
            typed = comm.store_loss_error(e, what)
            if typed is not None:
                raise typed from e
            raise

    # ----------------------------------------------------------------- save

    def save(self, payload: Dict) -> str:
        """One gang-consistent epoch: write this rank's shard, exchange
        CRCs, commit the manifest (rank 0 publishes it through the store;
        every rank persists it) behind the commit barrier. Returns this
        rank's shard path."""
        from .. import observability as _obs
        from ..parallel import comm
        os.makedirs(self.directory, exist_ok=True)
        t0 = time.perf_counter()
        # every rank proposes max(local epochs)+1 and the gang takes the
        # max: ranks whose directories diverged still agree on one epoch
        proposed = (self._local_epochs() or [0])[-1] + 1
        epoch = max(self._allgather(proposed, "gang_ckpt_epoch"))
        payload = dict(payload)
        payload["format_version"] = FORMAT_VERSION
        payload["checkpoint_id"] = epoch
        state = payload.get("state", {})
        with _obs.span("gang_checkpoint", epoch=epoch,
                       iteration=payload.get("iteration"), rank=self.rank,
                       world=self.world):
            shard_file = self.shard_name(epoch)
            crc, size = write_shard_file(
                os.path.join(self.directory, shard_file), payload)
            _obs.inc("gang.shard_writes")
            t1 = time.perf_counter()
            meta = {"rank": self.rank, "file": shard_file, "crc32": crc,
                    "size": size, "iteration": payload.get("iteration")}
            metas = self._allgather(meta, "gang_ckpt_meta")
            iters = sorted({m["iteration"] for m in metas})
            if len(iters) != 1:
                raise CheckpointError(
                    f"gang checkpoint epoch {epoch} is torn: ranks disagree "
                    f"on the iteration ({iters}) — refusing to commit a "
                    f"mixed-iteration manifest")
            manifest = {
                "manifest_version": MANIFEST_VERSION,
                "epoch": epoch,
                "iteration": payload.get("iteration"),
                "world": self.world,
                "n_devices": state.get("n_devices"),
                "tree_learner": state.get("tree_learner"),
                "config_fingerprint": payload.get("config_fingerprint"),
                "shards": sorted(metas, key=lambda m: m["rank"]),
            }
            raw = json.dumps(manifest, sort_keys=True, indent=1).encode()
            key = f"{_KV_PREFIX}/manifest/{epoch}"
            if self.client is not None:
                if self.rank == 0:
                    self._store_call(
                        lambda: self.client.set(key, raw),
                        f"gang manifest publish epoch={epoch}")
                else:
                    wait = datetime.timedelta(milliseconds=self.timeout_ms)

                    def _fetch():
                        self.client.wait([key], wait)
                        return bytes(self.client.get(key))
                    raw = self._store_call(
                        _fetch, f"gang manifest fetch epoch={epoch} "
                                f"rank={self.rank}")
            # every rank persists the manifest: resume verification is
            # local (each host sees only its own disk)
            _write_bytes_atomic(self.manifest_path(epoch), raw,
                                discriminator=f".r{self.rank:04d}")
            t2 = time.perf_counter()
            if self.client is not None:
                # the commit barrier: the epoch exists once every rank has
                # persisted its shard and the manifest
                lease = self.lease or _active_lease
                probe = None if lease is None else lease.probe
                what = f"gang commit barrier epoch={epoch} rank={self.rank}"
                commit = f"{_KV_PREFIX}/commit/{epoch}"
                try:
                    cycle = comm.arrive_and_wait(
                        self.client, commit, self.world, self.timeout_ms,
                        what=what, probe=probe)
                    # rank 0, the store's host, leaves the epoch last
                    comm.leave_last(self.client, f"{commit}/left",
                                    self.rank, self.world, cycle,
                                    self.timeout_ms, what=what, probe=probe)
                except CommRetryError:
                    _obs.inc("comm.barrier_failures")
                    raise                 # a lost peer: comm loss, 145
                except Exception as e:
                    _obs.inc("comm.barrier_failures")
                    raise CheckpointError(
                        f"gang checkpoint epoch {epoch} commit barrier "
                        f"failed on rank {self.rank} "
                        f"({type(e).__name__}: {e}) — a peer did not "
                        f"persist the epoch") from e
                if self.rank == 0:
                    try:
                        self.client.delete_key(key)
                    except Exception as e:               # noqa: BLE001
                        Log.debug("gang manifest key cleanup failed: %s: %s",
                                  type(e).__name__, e)
            t3 = time.perf_counter()
        self.timings = {"shard_write_s": t1 - t0, "exchange_s": t2 - t1,
                        "commit_s": t3 - t2, "total_s": t3 - t0}
        reg = _obs.get_registry()
        reg.histogram("gang.save_seconds").observe(t3 - t0)
        reg.histogram("gang.commit_seconds").observe(t3 - t2)
        _obs.inc("gang.manifest_commits")
        self._prune()
        Log.info("gang checkpoint epoch %d committed (iteration %s, rank "
                 "%d/%d, crc %#010x)", epoch, payload.get("iteration"),
                 self.rank, self.world, crc)
        return os.path.join(self.directory, shard_file)

    def _prune(self) -> None:
        """Keep the newest ``keep_last_n`` epochs: each rank unlinks its own
        old shards; rank 0 also the old manifests."""
        if self.keep_last_n <= 0:
            return
        keep = set(self._local_epochs()[-self.keep_last_n:])
        for epoch, path in list_manifests(self.directory):
            if epoch not in keep and self.rank == 0:
                try:
                    os.unlink(path)
                except OSError as e:
                    Log.warning("cannot prune gang manifest %s: %s", path, e)
        for name in os.listdir(self.directory):
            m = _SHARD_RE.match(name)
            if m and int(m.group(1)) not in keep \
                    and int(m.group(2)) == self.rank:
                try:
                    os.unlink(os.path.join(self.directory, name))
                except OSError as e:
                    Log.warning("cannot prune gang shard %s: %s", name, e)

    # -------------------------------------------------------------- resolve

    def local_verified_epochs(self) -> List[int]:
        """Epochs whose manifest parses and whose shard for this rank is
        present with a matching CRC."""
        out = []
        for epoch, path in list_manifests(self.directory):
            ok, detail = verify_manifest(path, self.directory,
                                         only_rank=self.rank)
            if ok:
                out.append(epoch)
            else:
                Log.warning("gang epoch %d is not verifiable on rank %d "
                            "(%s)", epoch, self.rank, detail)
        return out

    def resolve_resume(self) -> Optional[str]:
        """The gang half of ``resume_from=auto``: the newest epoch every
        rank verifies, agreed through an allgather of the verified sets.
        Returns this rank's shard path for it, or None when the directory
        holds no manifest (a fresh start). Raises when manifests exist but
        no common epoch verifies: silently retraining a gang from scratch
        is the torn resume this protocol prevents."""
        from .. import observability as _obs
        manifests = list_manifests(self.directory)
        local = self.local_verified_epochs()
        newest_known = manifests[-1][0] if manifests else 0
        views = self._allgather((sorted(local), newest_known), "gang_resume")
        common = set(views[0][0])
        for epochs, _ in views[1:]:
            common &= set(epochs)
        anyone_knows = max(v[1] for v in views)
        if not common:
            if anyone_knows:
                raise CheckpointError(
                    f"gang resume: manifests exist under {self.directory} "
                    f"(newest epoch {anyone_knows}) but no epoch verifies "
                    f"on every rank — refusing to silently retrain from "
                    f"scratch; audit with `python -m "
                    f"lightgbm_tpu_torch.robustness.checkpoint --verify "
                    f"{self.directory}` on each host")
            return None
        epoch = max(common)
        if epoch < anyone_knows:
            _obs.get_registry().counter("fault.gang_fallback_epochs").inc(
                anyone_knows - epoch)
            Log.warning("gang resume: falling back TOGETHER from epoch %d "
                        "to %d — some rank cannot verify the newer "
                        "epoch(s); a mixed-iteration resume is never "
                        "attempted", anyone_knows, epoch)
        manifest = load_manifest(self.manifest_path(epoch))
        if manifest.get("world") != self.world:
            if not self.elastic:
                Log.fatal(
                    "gang resume: epoch %d was written by a %s-rank gang "
                    "but this gang has %d rank(s). Elastic resume on a "
                    "different world size must be EXPLICIT: set "
                    "elastic=true (plus tpu_reshard_on_resume=true for the "
                    "row-block re-layout) or restart the original fleet",
                    epoch, manifest.get("world"), self.world)
            Log.warning("gang resume (elastic): epoch %d written under "
                        "world=%s, resuming under world=%d through "
                        "tpu_reshard_on_resume", epoch,
                        manifest.get("world"), self.world)
        shard = os.path.join(self.directory, self.shard_name(epoch))
        Log.info("gang resume: epoch %d agreed by all %d rank(s) — "
                 "resuming rank %d from %s", epoch, self.world, self.rank,
                 os.path.basename(shard))
        return shard


# ---------------------------------------------------------- heartbeat leases

class HeartbeatLease:
    """Per-rank liveness lease in the world's store.

    ``beat()`` (at the batch boundaries the watchdog beats at) bumps this
    rank's sequence number, rate-limited to ``interval_s``. ``probe()``,
    before each batch's collectives, raises ``PeerLostError`` naming a peer
    whose sequence has not advanced for ``lease_timeout_s`` by this
    process's monotonic clock (clock skew between hosts never fakes a
    death). ``attribution()`` is the non-raising variant the watchdog calls
    when it fires. A store call that fails because the store's host is
    gone names that host, rank 0, as lost."""

    def __init__(self, *, client, rank: int, world: int,
                 lease_timeout_s: float, interval_s: float = 0.0,
                 probe_timeout_ms: int = 200,
                 clock: Callable[[], float] = time.monotonic):
        if lease_timeout_s <= 0:
            raise ValueError(f"lease_timeout_s must be > 0, "
                             f"got {lease_timeout_s}")
        self.client = client
        self.rank = int(rank)
        self.world = int(world)
        self.lease_timeout_s = float(lease_timeout_s)
        self.interval_s = float(interval_s)
        self.probe_timeout_ms = int(probe_timeout_ms)
        self._clock = clock
        self._seq = 0
        self._last_write: Optional[float] = None
        self._last_probe: Optional[float] = None
        # rank -> (last seen seq, local time the seq last ADVANCED)
        self._peer_seen: Dict[int, Tuple[int, float]] = {}
        self._started = clock()

    def _key(self, rank: int) -> str:
        return f"{_KV_PREFIX}/hb/{rank}"

    # ---------------------------------------------------------------- beats

    def beat(self, force: bool = False) -> bool:
        """Bump this rank's lease (rate-limited; ``force`` ignores the
        interval). True when a store write happened."""
        now = self._clock()
        if not force and self._last_write is not None \
                and now - self._last_write < self.interval_s:
            return False
        self._seq += 1
        try:
            self.client.set(self._key(self.rank), str(self._seq).encode())
        except Exception as e:                               # noqa: BLE001
            # a failed beat must not take the loop down: the peers' lease
            # timeout covers a stretch without beats, and a lost store is
            # named by the next probe
            Log.warning("heartbeat beat failed on rank %d (%s: %s) — "
                        "peers' lease timeout covers the gap",
                        self.rank, type(e).__name__, e)
            return False
        self._last_write = now
        from .. import observability as _obs
        _obs.inc("comm.heartbeat_beats")
        return True

    # --------------------------------------------------------------- probes

    def _read_seq(self, r: int) -> Optional[int]:
        """Peer ``r``'s sequence number, None when it has none (yet, or
        withdrawn). Raises ``PeerLostError`` naming the store's host when
        the store is unreachable."""
        from ..parallel import comm
        key = self._key(r)
        try:
            if not self.client.check([key]):
                return None
            return int(bytes(self.client.get(key)))
        except Exception as e:                               # noqa: BLE001
            typed = comm.store_loss_error(
                e, f"heartbeat probe of rank {r} from rank {self.rank}")
            if typed is not None:
                raise typed from e
            # a store hiccup: the peer keeps aging by our clock, which is
            # what the lease measures
            Log.debug("heartbeat probe: no lease read for rank %d (%s: %s)",
                      r, type(e).__name__, e)
            return None

    def _peer_ages(self) -> Dict[int, float]:
        """Seconds since each peer's lease last advanced, by this process's
        clock (a peer that never wrote ages from the lease's start)."""
        now = self._clock()
        ages: Dict[int, float] = {}
        for r in range(self.world):
            if r == self.rank:
                continue
            seq = self._read_seq(r)
            prev = self._peer_seen.get(r)
            if seq is not None and (prev is None or seq != prev[0]):
                self._peer_seen[r] = (seq, now)
                ages[r] = 0.0
            else:
                ages[r] = now - (prev[1] if prev is not None
                                 else self._started)
        return ages

    def check_peers(self) -> Dict[int, float]:
        """One liveness pass over every peer; raises ``PeerLostError`` for
        the stalest expired lease. Returns the ages when all peers live."""
        from .. import observability as _obs
        ages = self._peer_ages()
        if ages:
            slowest = max(ages, key=lambda r: ages[r])
            _obs.get_registry().gauge("comm.slowest_rank").set(slowest)
            if ages[slowest] > self.lease_timeout_s:
                _obs.inc("fault.peer_lost")
                raise PeerLostError(
                    f"peer rank {slowest} is lost: heartbeat lease has not "
                    f"advanced for {ages[slowest]:.1f}s "
                    f"(gang_lease_timeout_s={self.lease_timeout_s:g}) — "
                    f"detected before entering the collective",
                    rank=slowest)
        return ages

    def probe(self) -> Optional[Dict[int, float]]:
        """The pre-batch probe, rate-limited to ``interval_s``: at most one
        read per peer per interval. The ages when a probe ran, else None."""
        now = self._clock()
        if self._last_probe is not None \
                and now - self._last_probe < self.interval_s:
            return None
        self._last_probe = now
        return self.check_peers()

    def attribution(self) -> Dict:
        """The watchdog's hook: read the leases without raising and report
        the slowest and the lost peer. Never raises."""
        from .. import observability as _obs
        try:
            ages = self._peer_ages()
        except PeerLostError as e:
            _obs.inc("fault.peer_lost")
            return {"peer_lease_ages_s": {}, "store_lost": True,
                    "lease_timeout_s": self.lease_timeout_s,
                    "slowest_rank": e.rank, "peer_lost": e.rank}
        except Exception as e:                               # noqa: BLE001
            return {"error": f"{type(e).__name__}: {e}"}
        out: Dict = {"peer_lease_ages_s": {str(r): round(a, 3)
                                           for r, a in ages.items()},
                     "lease_timeout_s": self.lease_timeout_s,
                     "slowest_rank": None, "peer_lost": None}
        if ages:
            slowest = max(ages, key=lambda r: ages[r])
            out["slowest_rank"] = slowest
            _obs.get_registry().gauge("comm.slowest_rank").set(slowest)
            if ages[slowest] > self.lease_timeout_s:
                out["peer_lost"] = slowest
                _obs.inc("fault.peer_lost")
        return out

    def withdraw(self) -> None:
        """Delete this rank's lease key (a clean end: peers see a missing
        lease age out instead of a frozen one). Best effort."""
        try:
            self.client.delete_key(self._key(self.rank))
        except Exception as e:                               # noqa: BLE001
            Log.debug("heartbeat withdraw failed: %s: %s",
                      type(e).__name__, e)


# --------------------------------------------------- mid-batch loss mapping

# substrings of what a collective or a store call raises when a peer
# process disappears: gloo's reset or closed TCP pair, its timeout, the
# store's network errors, NCCL's remote errors
_COMM_LOSS_SIGNATURES = (
    "gloo",
    "connection reset by peer",
    "connection closed by peer",
    "connection refused",
    "connection was likely closed",
    "broken pipe",
    "socket closed",
    "peer closed",
    "timed out waiting",
    "heartbeat timeout",
    "distnetworkerror",
    "diststoreerror",
    "distbackenderror",
    "nccl error",
    "remote process exited",
)


def comm_loss_error(exc: BaseException,
                    lease: Optional[HeartbeatLease] = None):
    """Map a raw error raised inside a batch (gloo's ``RuntimeError`` from
    a reset pair, a store ``DistNetworkError``) onto the typed comm-loss
    errors, reading the heartbeat leases for who died: ``PeerLostError``
    naming the rank, or ``CommTimeoutError`` when nobody can be named —
    either way the command line exits 145 and the fleet supervisor counts
    this rank as a survivor. A lost store names its host, rank 0. None when
    the error does not look like comm loss (re-raise the original)."""
    from ..parallel import comm
    from .retry import CommTimeoutError
    typed = comm.store_loss_error(exc, "collective failed mid-batch")
    if typed is not None:
        return typed
    msg = f"{type(exc).__name__}: {exc}".lower()
    if not any(sig in msg for sig in _COMM_LOSS_SIGNATURES):
        return None
    att = lease.attribution() if lease is not None else {}
    lost = att.get("peer_lost")
    suspect = att.get("slowest_rank")
    detail = f"{type(exc).__name__}: {exc}"
    if len(detail) > 500:
        detail = detail[:500] + "..."
    if lost is not None:
        return PeerLostError(
            f"collective failed mid-batch: peer rank {lost}'s heartbeat "
            f"lease expired ({detail})", rank=lost)
    if suspect is not None:
        return PeerLostError(
            f"collective failed mid-batch: transport to a peer died — "
            f"slowest lease is rank {suspect} ({detail})", rank=suspect)
    return CommTimeoutError(f"collective failed mid-batch: {detail}")
