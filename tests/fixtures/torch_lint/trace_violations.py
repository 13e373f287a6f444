"""Planted op-trace violations, one contract per check kind, loaded with
``python -m lightgbm_tpu_torch.analysis --trace --load <this file>`` (and
by ``tests/test_torch_trace_contracts.py``). Each program is recorded from
a few tensor operations chosen to break exactly its check."""
import torch

from lightgbm_tpu_torch.analysis.contracts import (TracedProgram, contract,
                                                   program_builder)
from lightgbm_tpu_torch.analysis.contracts import checks as C
from lightgbm_tpu_torch.analysis.contracts.op_trace import OpTrace, record

ENTRY = "fixture.planted"


def _recorded(fn):
    with record() as trace:
        fn()
    return trace


@program_builder(ENTRY, "sort")
def _sort():
    return TracedProgram(ENTRY, "sort", _recorded(
        lambda: torch.sort(torch.arange(5000.0), stable=True)))


@program_builder(ENTRY, "collectives")
def _collectives():
    return TracedProgram(ENTRY, "collectives", OpTrace(),
                         comm={"psum_scatter_hist": 8, "allgather_splits": 8},
                         collectives={"all_reduce": 1, "all_gather": 1})


@program_builder(ENTRY, "f64")
def _f64():
    return TracedProgram(ENTRY, "f64", _recorded(
        lambda: torch.ones(3).double() * 2))


@program_builder(ENTRY, "item")
def _item():
    return TracedProgram(ENTRY, "item", _recorded(
        lambda: torch.ones(3).sum().item()))


@program_builder(ENTRY, "cholesky")
def _cholesky():
    a = torch.eye(3)[None].repeat(2, 1, 1)
    return TracedProgram(ENTRY, "cholesky", _recorded(
        lambda: [torch.linalg.cholesky_ex(a), torch.linalg.cholesky_ex(a)]))


@program_builder(ENTRY, "kernel")
def _kernel():
    return TracedProgram(ENTRY, "kernel", OpTrace(kernel_passes=1),
                         expected_launches=2)


contract("TX90", "planted: a sort over rows", ENTRY,
         checks=[C.ForbidOps({"sort"}, min_numel=1000)], targets=["sort"])
contract("TX91", "planted: collectives off the cost model", ENTRY,
         checks=[C.RequiredCollectives()], targets=["collectives"])
contract("TX92", "planted: a silent f64", ENTRY,
         checks=[C.DtypeDiscipline()], targets=["f64"])
contract("TX93", "planted: a host read", ENTRY,
         checks=[C.NoHostTransfer()], targets=["item"])
contract("TX94", "planted: a second Cholesky", ENTRY,
         checks=[C.CountOp("linalg_cholesky_ex", 1)], targets=["cholesky"])
contract("TX95", "planted: a missing kernel pass", ENTRY,
         checks=[C.CountKernelLaunches()], targets=["kernel"])
