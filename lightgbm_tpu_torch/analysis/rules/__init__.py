"""Rule registry for torch-lint. Each rule module exposes a class with
``rule_id``, ``summary`` and ``check(ctx) -> Iterable[Finding]``; the
module names are the JAX package's (``lightgbm_tpu/analysis/rules/``), each
rule carrying its hazard into PyTorch's terms."""
from .control_flow import ControlFlowRule          # R001
from .host_sync import HostSyncRule                # R002
from .dtype_promotion import DtypePromotionRule    # R003
from .pallas_shapes import KernelBindingRule       # R004
from .static_args import BufferRebindRule          # R005
from .import_exec import ImportExecRule            # R006
from .sort_in_loop import SortInLoopRule           # R007
from .ad_hoc_timing import AdHocTimingRule         # R008
from .device_transfer import DeviceTransferRule    # R009
from .swallowed_exceptions import SwallowedExceptionRule  # R010
from .serving_sync import ServingSyncRule          # R011
from .thread_leak import ThreadLeakRule            # R012
from .kv_isolation import KVIsolationRule          # R013

_RULES = None


def active_rules():
    global _RULES
    if _RULES is None:
        _RULES = [ControlFlowRule(), HostSyncRule(), DtypePromotionRule(),
                  KernelBindingRule(), BufferRebindRule(), ImportExecRule(),
                  SortInLoopRule(), AdHocTimingRule(), DeviceTransferRule(),
                  SwallowedExceptionRule(), ServingSyncRule(),
                  ThreadLeakRule(), KVIsolationRule()]
    return _RULES
