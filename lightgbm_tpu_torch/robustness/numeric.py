"""Non-finite guards for the boosting step (``nan_policy``); port of
``lightgbm_tpu/robustness/numeric.py`` on tensors.

An exploding objective (a custom ``fobj`` bug, an extreme init score, a
learning-rate schedule gone wrong) poisons gradients or hessians with NaN
or Inf, and one poisoned iteration corrupts every later tree. With
``nan_policy != "none"`` the booster (boosting/gbdt.py) reduces the
gradients, hessians and shrunk leaf outputs of every iteration to three
device flags:

- under ``raise`` / ``skip_iter`` the iteration's score, valid scores and
  bagging mask are gated (``torch.where(bad, before, after)``), so a
  poisoned iteration leaves them bit-identical to their values before it
  and the host only pops its bookkeeping;
- ``clip`` sanitises g/h and leaf outputs in the step (NaN -> 0, +-Inf ->
  +-``CLIP_CAP``) and logs that it fired.

Policies: ``none`` (default: no guard), ``raise`` (fail loudly, state
left clean and checkpointable), ``skip_iter`` (drop the iteration and go
on; ten in a row abort), ``clip`` (sanitise and go on).
"""
from __future__ import annotations

import torch

NAN_POLICIES = ("none", "raise", "skip_iter", "clip")


class NonFiniteError(RuntimeError):
    """nan_policy="raise": non-finite values in the boosting step. Raised
    after the poisoned iteration's bookkeeping is popped, so the booster is
    clean and checkpointable at the failure point."""


# finite stand-in for +-Inf under nan_policy=clip: large enough to keep the
# ordering, small enough that squares and sums stay inside f32
CLIP_CAP = 1e30

FLAG_NAMES = ("gradients", "hessians", "leaf outputs")


def nonfinite_flag(x: torch.Tensor) -> torch.Tensor:
    """0-d bool tensor on ``x``'s device: any element is NaN or Inf."""
    return ~torch.isfinite(x).all()


def clip_nonfinite(x: torch.Tensor, cap: float = CLIP_CAP) -> torch.Tensor:
    """NaN -> 0, +-Inf -> +-cap, finite values in ``[-cap, cap]`` kept."""
    return torch.nan_to_num(x, nan=0.0, posinf=cap, neginf=-cap).clamp(
        -cap, cap)
