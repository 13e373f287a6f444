"""Static and runtime hygiene tooling for the PyTorch/CUDA port (the port
of ``lightgbm_tpu/analysis/``, ROADMAP A19).

- ``tpu_lint`` — torch-lint, an AST analyzer of rules R001-R013 (host
  syncs on the hot path, Python branches on device tensors and rebound
  buffers in the captured parts, kernel bindings against their C
  interface, import-time CUDA work, ...). CLI: ``python -m
  lightgbm_tpu_torch.analysis lightgbm_tpu_torch/``. Stdlib only.
- ``trace_lint`` / ``contracts`` — the op-trace tier (``--trace``):
  contracts over the aten operations a shipped entry point dispatches,
  recorded on the CPU (no sort over rows in the wave, no host transfer in
  a captured part, no f64 outside its allowlist, one batched Cholesky per
  linear fit, collectives as ``collective_bytes`` charges them).
- ``guards`` — ``CaptureGuard``, the counterpart of the JAX package's
  ``RecompileGuard``: CUDA graph captures after warm-up and host syncs,
  as a report ``observability.phases.PhaseBreakdown.attach_guard`` takes.

Importing this package imports no torch: the guard and the trace tier
import it when they run.
"""
from .guards import CaptureGuard, GuardViolation, capture_guard  # noqa: F401
from .tpu_lint import Finding, lint_paths, main  # noqa: F401
