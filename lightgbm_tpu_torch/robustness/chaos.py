"""Deterministic fault injection for streamed training: a bit flip in a
host code shard, which the per-shard CRC32 (``ops/stream.py``) must catch.

The part of ``lightgbm_tpu/robustness/chaos.py`` (:38-42, :255,
:315-345) that ``tpu_residency=stream`` needs. The default seed comes
from ``LGBM_TPU_CHAOS_SEED``, so a failing chaos run replays bit for bit.
"""
from __future__ import annotations

import os
import random
from typing import Optional

from ..utils.log import Log

ENV_FLIP_SHARD = "LGBM_TPU_CHAOS_FLIP_SHARD"    # marker-file path


def default_seed() -> int:
    try:
        return int(os.environ.get("LGBM_TPU_CHAOS_SEED", "1234"))
    except ValueError:
        return 1234


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
