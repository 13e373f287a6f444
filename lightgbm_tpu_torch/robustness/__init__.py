"""Fault tolerance: checkpoint/resume with integrity and lineage
fallback, crash and fleet supervision, hang detection, gang-consistent
checkpoints with heartbeat leases, comm retry, numeric guards and the
chaos harness. Ports of ``lightgbm_tpu/robustness/*`` on
``torch.distributed``:

- ``checkpoint``  — atomic, CRC32-enveloped booster snapshots and resume;
                    ``latest_verified`` walks back past corrupt ones;
                    ``python -m lightgbm_tpu_torch.robustness.checkpoint
                    --verify DIR`` (gang directories too).
- ``supervisor``  — relaunch a killed or wedged ``python -m
                    lightgbm_tpu_torch`` child with ``resume_from=auto``
                    under bounded restarts and backoff, with measured
                    recovery time (MTTR); ``--fleet=N`` supervises a gang
                    of ranks with per-rank attribution and elastic shrink.
- ``watchdog``    — hang detection at the engine's batch boundaries;
                    dumps thread stacks and the observability snapshot,
                    optionally aborts to the last checkpoint (exit 142, or
                    145 when the lease attribution names a lost peer).
- ``distributed`` — gang-consistent epochs (every rank's shard, rank 0's
                    manifest, a commit barrier on the store), heartbeat
                    leases with typed ``PeerLostError``, the agreed-epoch
                    and elastic resume, and the mapping of what a dead
                    peer makes torch raise (``comm_loss_error``).
- ``retry``       — bounded retry with backoff for the store's exchanges.
- ``numeric``     — the ``nan_policy`` guard (raise | skip_iter | clip).
- ``chaos``       — deterministic fault injection: store delays, drops and
                    corruption on the torch ``Store`` API, killers, shard
                    bit flips, hang injection, poisoned gradients.
"""
from __future__ import annotations

# the exports resolve lazily, so that `python -m
# lightgbm_tpu_torch.robustness.<module>` runs a module this package has not
# imported yet
_EXPORTS = {
    "CheckpointError": "checkpoint", "CheckpointManager": "checkpoint",
    "config_fingerprint": "checkpoint", "verify_checkpoint": "checkpoint",
    "GangCheckpointCoordinator": "distributed",
    "HeartbeatLease": "distributed", "comm_loss_error": "distributed",
    "gang_env": "distributed",
    "CommRetryError": "retry", "CommTimeoutError": "retry",
    "PeerLostError": "retry", "retry_call": "retry",
    "Supervisor": "supervisor", "FleetSupervisor": "supervisor",
    "describe_exit": "supervisor",
    "HangWatchdog": "watchdog", "EXIT_HANG": "watchdog",
    "EXIT_COMM_LOST": "watchdog",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib
        return getattr(importlib.import_module(f".{_EXPORTS[name]}",
                                               __name__), name)
    raise AttributeError(name)
