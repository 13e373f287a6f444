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

``allowed_host_sync(reason)`` marks a function as an audited host-sync
point (torch-lint rules R002 and R011 skip it).
"""
from __future__ import annotations


def allowed_host_sync(reason: str):
    """Mark a function as an *intentional*, annotated host-sync point (the
    port's copy of ``lightgbm_tpu/robustness/__init__.py``'s).

    torch-lint rule R002 flags implicit host syncs (``.item()``,
    ``.tolist()``, ``.cpu()``, ``int(t)``) in hot-path modules and R011 in
    the serving dispatch; a function carrying this decorator is an audited
    sync point (the captured iteration's flag read per tree, the
    checkpoint fetch, the ``nan_policy`` flags) and is skipped — the
    annotation records *why* the sync is the contract, next to the code.
    """
    if not isinstance(reason, str) or not reason.strip():
        raise ValueError("allowed_host_sync requires a non-empty reason")

    def deco(fn):
        fn.__host_sync_reason__ = reason
        return fn

    return deco


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
__all__ = sorted(_EXPORTS) + ["allowed_host_sync"]


def __getattr__(name):
    if name in _EXPORTS:
        import importlib
        return getattr(importlib.import_module(f".{_EXPORTS[name]}",
                                               __name__), name)
    raise AttributeError(name)
