"""Atomic checkpoint store for booster training state; port of
``lightgbm_tpu/robustness/checkpoint.py`` for one device.

Layout: one file per snapshot inside ``checkpoint_dir``,
``ckpt_0000000001.pkl``, ``ckpt_0000000002.pkl``, ... with increasing ids
(derived from the files present, so a resumed process counts on where the
killed one stopped). A write goes to a temporary file, is fsynced, renamed
over the final name with ``os.replace`` and the directory is fsynced, so a
preemption never leaves a truncated snapshot under a final name, only a
``*.tmp.*`` orphan that the next save sweeps. ``keep_last_n`` prunes old
snapshots after each save (0 keeps all).

Every snapshot is wrapped in the JAX package's integrity envelope, byte
for byte: ``LGBMCKP2``, the CRC32 of the payload and its length (little
endian), then the pickled payload. ``load`` checks the checksum before
unpickling; ``latest_verified`` walks back to the newest snapshot that
verifies (``resume_from="auto"``). Each package's ``--verify`` reads the
other's files: ``python -m lightgbm_tpu_torch.robustness.checkpoint
--verify DIR`` audits a directory from the shell.

The payload holds builtins and numpy arrays only, never a class of either
package, and this module unpickles it through a ``find_class`` that admits
only those. A snapshot of the JAX package (whose forest is
``lightgbm_tpu`` tree objects) is therefore refused, naming that package,
and never imported.

Each payload carries a config fingerprint (SHA-256 over the
training-semantics subset of the Config, the JAX package's function), and
resume fails naming the fields that differ. Run-control fields (paths,
verbosity, the checkpoint knobs, ``num_iterations``, ``tpu_ingest``) are
left out of it.

The payload schema (``FORMAT_VERSION`` 1)::

    {"format_version": 1, "checkpoint_id": int,
     "config_fingerprint": str, "config": {trainable-subset dict},
     "iteration": int, "state": {GBDT.checkpoint_state()},
     "booster": {...}, "eval_history": {...}}
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import pickle
import re
import struct
import zlib
from typing import Dict, List, Optional, Tuple

from ..utils.log import Log

FORMAT_VERSION = 1

# magic(8) | crc32-of-payload(u32 LE) | payload-length(u64 LE) | payload
ENVELOPE_MAGIC = b"LGBMCKP2"
_ENVELOPE = struct.Struct("<8sIQ")

_FILE_RE = re.compile(r"^ckpt_(\d{10})\.pkl$")

# what a payload may hold: builtin containers and scalars, and numpy arrays,
# dtypes and scalars (each numpy spelling of their reconstructors)
_SAFE_BUILTINS = frozenset({
    "dict", "list", "tuple", "set", "frozenset", "int", "float", "complex",
    "str", "bytes", "bytearray", "bool", "slice", "range"})
_SAFE_NUMPY = frozenset({
    ("numpy", "ndarray"), ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"), ("numpy._core.multiarray", "scalar"),
    ("numpy.core.numeric", "_frombuffer"),
    ("numpy._core.numeric", "_frombuffer")})


class _PayloadUnpickler(pickle.Unpickler):
    """Admits builtins and numpy only; a class of any package is refused
    before its module is imported."""

    def find_class(self, module: str, name: str):
        if module == "builtins" and name in _SAFE_BUILTINS:
            return super().find_class(module, name)
        if (module, name) in _SAFE_NUMPY or (
                module == "numpy" and name.endswith("DType")) or (
                module == "numpy.dtypes" and name.endswith("DType")):
            return super().find_class(module, name)
        if module.split(".")[0] == "lightgbm_tpu":
            raise pickle.UnpicklingError(
                f"the snapshot holds {module}.{name}: it was written by the "
                f"JAX package (lightgbm_tpu), whose forest is its own tree "
                f"objects; lightgbm_tpu_torch resumes only its own snapshots "
                f"(builtins and numpy arrays)")
        raise pickle.UnpicklingError(
            f"the snapshot holds {module}.{name}: a lightgbm_tpu_torch "
            f"payload holds builtins and numpy arrays only")


# Config fields with no bearing on the trained model's content: two runs
# differing only here are resumable into each other. Everything else is
# fingerprinted — a silent objective/num_leaves/seed change across a resume
# is exactly the corruption this check exists to catch.
VOLATILE_CONFIG_FIELDS = frozenset({
    # run control / IO
    "task", "data", "valid_data", "init_score_file",
    "valid_init_score_file", "snapshot_freq", "output_model",
    "output_result", "convert_model", "convert_model_language",
    "input_model", "model_format", "num_iteration_predict",
    "is_predict_leaf_index", "is_predict_contrib", "is_predict_raw_score",
    "is_save_binary_file", "verbose", "num_threads",
    # resuming a run LONGER than originally planned is the point
    "num_iterations",
    # checkpointing's own knobs (tpu_reshard_on_resume included: it gates
    # HOW a resume re-lays-out state, not what the model trains to — the
    # device-count check itself lives in restore_checkpoint_state)
    "checkpoint_dir", "checkpoint_interval", "checkpoint_keep_last_n",
    "resume_from", "tpu_reshard_on_resume",
    # out-of-core transport knobs (docs/Fault-Tolerance.md "resume with a
    # different shard size"): residency and shard size change WHERE the
    # codes live and how they move, never the math — the shard size
    # divides the padded per-device rows, so chunk boundaries, the bagging
    # RNG shapes, and every histogram fold are identical across values.
    # The one behavioral coupling (stream forces tpu_row_compact=false) is
    # covered by tpu_row_compact itself staying fingerprinted.
    "tpu_residency", "tpu_stream_shard_rows", "tpu_hbm_budget_bytes",
    # device-side ingest (ops/ingest.py): changes WHERE binning runs and
    # how raw rows travel, never the codes — device ingest is bit-identical
    # to host binning (tests/test_ingest.py) or it falls back to host
    "tpu_ingest", "tpu_ingest_chunk_rows", "tpu_ingest_prefetch",
    # self-healing knobs (robustness/watchdog.py, ops/stream.py CRC check):
    # detection-and-recovery policy, never training math — a snapshot from
    # a watchdog-aborted run resumes under any watchdog/verify settings
    "hang_timeout_s", "hang_median_factor", "hang_action",
    "tpu_stream_verify",
    # distributed fault tolerance (robustness/distributed.py): heartbeat
    # cadence, lease deadlines, and the elastic-resume permission are
    # detection/recovery policy — a gang snapshot resumes under any of
    # them (elastic in particular MUST be settable on the restart that
    # shrinks the fleet)
    "gang_heartbeat_interval_s", "gang_lease_timeout_s", "elastic",
    # cluster wiring: the restarted pod gets fresh addresses/ports
    "machines", "machine_list_file", "local_listen_port", "time_out",
    # profiling/telemetry (observability/: spans, exporters, profiler window)
    "tpu_time_tag", "tpu_profile_dir", "tpu_profile_iters", "telemetry_dir",
    # cost/memory introspection (observability/costs.py, snapshot dumps)
    "tpu_cost_analysis", "dump_snapshot",
    # serving knobs (lightgbm_tpu/serving): bucket ladder, batcher policy,
    # and the resilience knobs (admission bound, deadlines, circuit
    # breaker, probe cadence) shape INFERENCE dispatch only — a checkpoint
    # trained under any of them resumes under any other
    "serve_max_batch_rows", "serve_max_wait_ms", "serve_buckets",
    "serve_max_queue_rows", "serve_deadline_ms", "serve_breaker_failures",
    "serve_breaker_window_s", "serve_probe_interval_s",
    # linear-tree loudness knob (config.py): warning cadence only — the
    # model-changing linear knobs (linear_tree / linear_lambda /
    # linear_max_features) deliberately STAY fingerprinted
    "tpu_linear_warn_fallback",
})


class CheckpointError(RuntimeError):
    """A checkpoint could not be written, located, parsed, or validated."""


def _fsync_dir(directory: str) -> None:
    """fsync a directory's metadata (renames/unlinks inside it). Best-effort
    on platforms whose directories cannot be opened — logged, never raised:
    the snapshot itself is already fsynced and atomic either way."""
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError as e:
        Log.debug("cannot open %s for directory fsync: %s", directory, e)
        return
    try:
        os.fsync(fd)
    except OSError as e:
        Log.debug("directory fsync failed for %s: %s", directory, e)
    finally:
        os.close(fd)


def fingerprinted_config(config) -> Dict:
    """The training-semantics subset of ``config`` that the fingerprint
    covers (and that is stored in the payload for mismatch diagnostics)."""
    return {k: v for k, v in config.to_dict().items()
            if k not in VOLATILE_CONFIG_FIELDS}


def config_fingerprint(config) -> str:
    """SHA-256 over the canonical JSON of the non-volatile config fields."""
    blob = json.dumps(fingerprinted_config(config), sort_keys=True,
                      default=str)
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()


def config_mismatch_fields(stored: Dict, config) -> List[str]:
    """Field names whose stored value differs from ``config``'s."""
    current = fingerprinted_config(config)
    keys = set(stored) | set(current)
    return sorted(k for k in keys
                  if stored.get(k, "<missing>") != current.get(k, "<missing>"))


class CheckpointManager:
    """Directory of atomically-written, monotonically-numbered snapshots."""

    def __init__(self, directory: str, keep_last_n: int = 3):
        if not directory:
            raise CheckpointError("checkpoint_dir is empty — set "
                                  "checkpoint_dir=...")
        if keep_last_n < 0:
            raise CheckpointError(f"keep_last_n must be >= 0, got {keep_last_n}")
        self.directory = directory
        self.keep_last_n = keep_last_n

    # ------------------------------------------------------------- listing

    def list_checkpoints(self) -> List[Tuple[int, str]]:
        """``[(checkpoint_id, path)]`` sorted ascending by id."""
        if not os.path.isdir(self.directory):
            return []
        out = []
        for name in os.listdir(self.directory):
            m = _FILE_RE.match(name)
            if m:
                out.append((int(m.group(1)),
                            os.path.join(self.directory, name)))
        out.sort()
        return out

    def latest(self) -> Optional[str]:
        cks = self.list_checkpoints()
        return cks[-1][1] if cks else None

    # -------------------------------------------------------------- saving

    def save(self, payload: Dict) -> str:
        """Write one snapshot atomically; returns the final path. The write
        is a telemetry span + counter (``checkpoint.writes``): checkpoint
        cadence and cost show up next to the training spans they interleave
        with (docs/Observability.md)."""
        from .. import observability as _obs
        os.makedirs(self.directory, exist_ok=True)
        existing = self.list_checkpoints()
        ckpt_id = (existing[-1][0] + 1) if existing else 1
        payload = dict(payload)
        payload["format_version"] = FORMAT_VERSION
        payload["checkpoint_id"] = ckpt_id
        path = os.path.join(self.directory, f"ckpt_{ckpt_id:010d}.pkl")
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with _obs.span("checkpoint", checkpoint_id=ckpt_id,
                           iteration=payload.get("iteration")):
                raw = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
                header = _ENVELOPE.pack(ENVELOPE_MAGIC,
                                        zlib.crc32(raw) & 0xFFFFFFFF,
                                        len(raw))
                with open(tmp, "wb") as fh:
                    fh.write(header)
                    fh.write(raw)
                    fh.flush()
                    os.fsync(fh.fileno())
                os.replace(tmp, path)
                # make the RENAME durable too: the new directory entry lives
                # in the parent dir's metadata, which the file fsync above
                # does not cover — a crash here must not resurrect the old
                # directory state and lose the snapshot
                _fsync_dir(self.directory)
        except OSError as e:
            _obs.inc("checkpoint.write_failures")
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise CheckpointError(f"cannot write checkpoint {path}: {e}") from e
        _obs.inc("checkpoint.writes")
        self._prune()
        self._sweep_tmp()
        return path

    def _prune(self) -> None:
        if self.keep_last_n <= 0:
            return
        cks = self.list_checkpoints()
        for _id, path in cks[:-self.keep_last_n]:
            try:
                os.unlink(path)
            except OSError as e:
                Log.warning("cannot prune old checkpoint %s: %s", path, e)

    def _sweep_tmp(self) -> int:
        """Remove orphaned temp files from writers killed mid-snapshot
        (a ``kill -9`` during ``save`` leaves ``*.pkl.tmp.<pid>`` behind —
        never a half-written ``ckpt_*.pkl``). Returns how many were swept;
        the directory is fsynced after a sweep so the unlinks are durable."""
        try:
            names = os.listdir(self.directory)
        except OSError:
            return 0
        swept = 0
        for name in names:
            if ".pkl.tmp." in name:
                try:
                    os.unlink(os.path.join(self.directory, name))
                    swept += 1
                except OSError as e:
                    Log.debug("cannot sweep orphaned tmp %s: %s", name, e)
        if swept:
            Log.info("swept %d orphaned checkpoint tmp file(s) from %s "
                     "(a previous writer was killed mid-snapshot)",
                     swept, self.directory)
            _fsync_dir(self.directory)
        return swept

    # ------------------------------------------------------------- loading

    @staticmethod
    def resolve(path_or_dir: str) -> str:
        """A checkpoint file path, or the latest snapshot of a directory."""
        if os.path.isdir(path_or_dir):
            latest = CheckpointManager(path_or_dir).latest()
            if latest is None:
                raise CheckpointError(
                    f"no checkpoints (ckpt_*.pkl) found in {path_or_dir}")
            return latest
        if not os.path.exists(path_or_dir):
            raise CheckpointError(f"checkpoint {path_or_dir} does not exist")
        return path_or_dir

    def latest_verified(self) -> Optional[str]:
        """The newest snapshot that passes :func:`verify_checkpoint`,
        walking BACK through the lineage (``resume_from="auto"``): a
        truncated or bit-flipped latest costs one checkpoint interval
        instead of the run. Corrupt snapshots are skipped with a warning
        (and counted as ``fault.checkpoint_corrupt``) but left on disk for
        forensics. Returns None when the directory holds no snapshots at
        all; raises when snapshots exist but NONE verifies — silently
        retraining from scratch over an all-corrupt lineage is exactly the
        surprise this walk exists to prevent."""
        from .. import observability as _obs
        cks = self.list_checkpoints()
        for ckpt_id, path in reversed(cks):
            ok, detail = verify_checkpoint(path)
            if ok:
                return path
            _obs.inc("fault.checkpoint_corrupt")
            Log.warning("checkpoint %s failed verification (%s) — falling "
                        "back to the previous snapshot", path, detail)
        if cks:
            raise CheckpointError(
                f"all {len(cks)} snapshot(s) in {self.directory} failed "
                f"verification — refusing to silently retrain from scratch; "
                f"inspect with `python -m lightgbm_tpu_torch.robustness.checkpoint "
                f"--verify {self.directory}` and delete the directory to "
                f"start fresh deliberately")
        return None

    @staticmethod
    def _read_payload_bytes(path: str) -> Tuple[bytes, bool]:
        """(payload bytes, had_envelope) — envelope parsed and CRC-verified
        when present; a pre-envelope file returns its raw bytes."""
        try:
            with open(path, "rb") as fh:
                data = fh.read()
        except OSError as e:
            raise CheckpointError(
                f"cannot read checkpoint {path}: {e}") from e
        if not data.startswith(ENVELOPE_MAGIC):
            # legacy bare pickle (pre-integrity-envelope) — no checksum to
            # check against; the pickle parse + schema checks still apply
            Log.debug("checkpoint %s predates the integrity envelope "
                      "(no checksum to verify)", path)
            return data, False
        if len(data) < _ENVELOPE.size:
            raise CheckpointError(
                f"{path} is shorter than its envelope header "
                f"(corrupt or truncated snapshot?)")
        _magic, crc, length = _ENVELOPE.unpack_from(data)
        raw = data[_ENVELOPE.size:]
        if len(raw) != length:
            raise CheckpointError(
                f"{path} payload is {len(raw)} bytes but the envelope "
                f"records {length} (corrupt or truncated snapshot?)")
        actual = zlib.crc32(raw) & 0xFFFFFFFF
        if actual != crc:
            raise CheckpointError(
                f"{path} failed its integrity check: payload crc32 "
                f"{actual:#010x} != recorded {crc:#010x} (corrupt or "
                f"truncated snapshot? bit rot?)")
        return raw, True

    @staticmethod
    def _validate_payload(raw: bytes, path: str) -> Dict:
        """Unpickle + schema-validate already-CRC-verified payload bytes."""
        try:
            payload = _PayloadUnpickler(io.BytesIO(raw)).load()
        except (pickle.UnpicklingError, EOFError, AttributeError,
                ImportError, IndexError, ValueError, MemoryError) as e:
            raise CheckpointError(
                f"cannot load checkpoint {path}: {type(e).__name__}: {e} "
                f"(corrupt or truncated snapshot?)") from e
        if not isinstance(payload, dict) or "format_version" not in payload:
            raise CheckpointError(
                f"{path} is not a lightgbm_tpu checkpoint (no format_version)")
        if payload["format_version"] != FORMAT_VERSION:
            raise CheckpointError(
                f"{path} has format_version={payload['format_version']}; "
                f"this build reads version {FORMAT_VERSION}")
        for key in ("config_fingerprint", "config", "state", "iteration"):
            if key not in payload:
                raise CheckpointError(f"{path} is missing the {key!r} field "
                                      f"— corrupt snapshot?")
        return payload

    @staticmethod
    def load(path_or_dir: str) -> Dict:
        """Load, checksum-verify, and schema-validate one snapshot (fails
        loudly on truncation/corruption — a half-written or bit-flipped
        pickle must never resume)."""
        path = CheckpointManager.resolve(path_or_dir)
        raw, _ = CheckpointManager._read_payload_bytes(path)
        return CheckpointManager._validate_payload(raw, path)


# ------------------------------------------------------------- verification

def verify_checkpoint(path: str) -> Tuple[bool, str]:
    """Full integrity check of one snapshot FILE: envelope checksum,
    pickle parse, schema validation — one read of the file. Returns
    ``(ok, detail)`` — never raises, so lineage walks and the ``--verify``
    CLI can report every snapshot's state."""
    try:
        raw, had_envelope = CheckpointManager._read_payload_bytes(path)
        payload = CheckpointManager._validate_payload(raw, path)
    except CheckpointError as e:
        return False, str(e)
    detail = (f"iteration {payload.get('iteration')}, checkpoint_id "
              f"{payload.get('checkpoint_id')}")
    if not had_envelope:
        detail += " [legacy: no checksum envelope]"
    return True, detail


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m lightgbm_tpu_torch.robustness.checkpoint --verify
    DIR|FILE``: audit every snapshot's integrity from the shell (safe on a
    live run's directory). Exit codes: 0 every snapshot verifies; 1 some
    are corrupt but a verified resume target exists (named on stdout); 2
    no usable snapshot (none found, or all corrupt)."""
    import argparse
    import sys
    ap = argparse.ArgumentParser(
        prog="python -m lightgbm_tpu_torch.robustness.checkpoint",
        description="Verify checkpoint snapshot integrity")
    ap.add_argument("--verify", required=True, metavar="DIR_OR_FILE",
                    help="checkpoint directory (or one snapshot file)")
    args = ap.parse_args(argv)

    target = args.verify
    if os.path.isfile(target):
        entries = [(None, target)]
    else:
        entries = CheckpointManager(target).list_checkpoints() \
            if os.path.isdir(target) else []
        if not entries:
            print(f"no checkpoints (ckpt_*.pkl) found under {target}",
                  file=sys.stderr)
            return 2
    newest_ok, n_bad = None, 0
    for _ckpt_id, path in entries:
        ok, detail = verify_checkpoint(path)
        print(f"{os.path.basename(path):<24} "
              f"{'OK     ' if ok else 'CORRUPT'}  {detail}")
        if ok:
            newest_ok = path
        else:
            n_bad += 1
    if newest_ok is None:
        print("no verified snapshot — nothing to resume from",
              file=sys.stderr)
        return 2
    print(f"resume target: {newest_ok}")
    return 1 if n_bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
