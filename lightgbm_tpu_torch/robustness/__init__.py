"""Fault tolerance for one device: ``checkpoint`` (atomic, CRC-checked
booster snapshots and resume, ``python -m
lightgbm_tpu_torch.robustness.checkpoint --verify DIR``) and ``numeric``
(the ``nan_policy`` guard of the boosting step). Ports of
``lightgbm_tpu/robustness/checkpoint.py`` and ``numeric.py``; the
watchdog, supervisor, chaos harness and gang checkpoints of that package
are ROADMAP A17b.
"""
