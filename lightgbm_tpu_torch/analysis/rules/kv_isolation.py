"""R013: direct store and barrier calls outside the comm layer.

The ``torch.distributed`` store (``TCPStore``: ``set`` / ``get`` /
``wait`` / ``add`` / ``compare_set`` / ``delete_key``) and
``dist.barrier()`` are the one channel every rank of a gang depends on,
and every call on them carries the whole distributed-failure surface: a
dead rank 0 takes the store with it, so a timeout must be attributed to
a rank (``parallel/comm.store_loss_error``), retried with bounded backoff
(``robustness/retry.py``), seen by the chaos harness, and ordered with
the gang protocols (heartbeat leases, manifests, commit barriers). A
direct call anywhere else hangs untyped at the first flap.

Scope: ``lightgbm_tpu_torch/`` EXCEPT ``parallel/comm.py`` (the layer
that owns the store, ``host_allgather``, ``arrive_and_wait``) and
``robustness/distributed.py`` (the gang protocols built on it). Matched
on the receiver's name (``store``, ``self._store``, ``kv_store``,
``kv``) and on ``dist.barrier`` / ``torch.distributed.barrier``.
"""
from __future__ import annotations

import ast
import re

from .common import dotted_name, in_package

RULE_ID = "R013"

_STORE_METHODS = {"set", "get", "wait", "add", "compare_set", "delete_key",
                  "multi_get", "multi_set", "append", "check", "num_keys"}
_BARRIERS = {"dist.barrier", "torch.distributed.barrier",
             "distributed.barrier", "dist.monitored_barrier",
             "torch.distributed.monitored_barrier"}
_STORE_NAME = re.compile(r"(^|_)(store|kv)$", re.I)
_EXEMPT = ("lightgbm_tpu_torch/parallel/comm.py",
           "lightgbm_tpu_torch/robustness/distributed.py")


def _in_scope(rel: str) -> bool:
    rel = rel.replace("\\", "/")
    return in_package(rel) and not any(rel.endswith(m) for m in _EXEMPT)


class KVIsolationRule:
    rule_id = RULE_ID
    summary = ("torch.distributed store set/get/wait/add or dist.barrier "
               "outside parallel/comm.py and robustness/distributed.py "
               "(bypasses the comm layer's loss attribution, retry and "
               "chaos)")

    def check(self, ctx):
        if not _in_scope(ctx.rel):
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func) or ""
            if name in _BARRIERS:
                what = name
            elif isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _STORE_METHODS:
                recv = node.func.value
                leaf = recv.attr if isinstance(recv, ast.Attribute) else \
                    recv.id if isinstance(recv, ast.Name) else ""
                if not _STORE_NAME.search(leaf):
                    continue
                what = name or f"<store>.{node.func.attr}"
            else:
                continue
            yield ctx.finding(
                self.rule_id, node,
                f"`{what}(...)` talks to the torch.distributed store / "
                f"barrier directly — outside parallel/comm.py and "
                f"robustness/distributed.py this bypasses the loss "
                f"attribution (store_loss_error), retry_call's bounded "
                f"backoff and the chaos harness; use parallel.comm "
                f"helpers (host_allgather, arrive_and_wait) or the "
                f"robustness/distributed.py protocols")
