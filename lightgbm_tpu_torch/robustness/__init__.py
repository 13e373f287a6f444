"""Fault tolerance for one device: ``checkpoint`` (atomic, CRC-checked
booster snapshots and resume, ``python -m
lightgbm_tpu_torch.robustness.checkpoint --verify DIR``) and ``numeric``
(the ``nan_policy`` guard of the boosting step) and ``chaos`` (the
shard bit flip of streamed training). Ports of
``lightgbm_tpu/robustness/checkpoint.py``, ``numeric.py`` and part of
``chaos.py``; the watchdog, supervisor, the rest of the chaos harness and
gang checkpoints of that package are ROADMAP A17b.
"""
