"""Leveled logger mirroring the reference's Log facility.

Reference: include/LightGBM/utils/log.h:43-104 — leveled, thread-local level,
optional callback sink. Here: a thin layer over `logging` with the same levels
(Fatal raises, matching Log::Fatal's process-abort role in a library context).
"""
from __future__ import annotations

import logging

_logger = logging.getLogger("lightgbm_tpu_torch")

# Handler-identity marker: the logging module's logger dict outlives this
# module object, so a re-import (pytest importmode variations, importlib
# reload) sees the logger again. Guarding on `_logger.handlers` truthiness
# is wrong in both directions — a foreign handler (pytest's caplog, an
# embedding app) would suppress OUR handler entirely, while our own handler
# from a previous import is indistinguishable from one. Tag the handler and
# guard on the tag.
_HANDLER_TAG = "_lightgbm_tpu_torch_handler"
if not any(getattr(h, _HANDLER_TAG, False) for h in _logger.handlers):
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("[LightGBM-Torch] [%(levelname)s] %(message)s"))
    setattr(_h, _HANDLER_TAG, True)
    _logger.addHandler(_h)
    _logger.setLevel(logging.INFO)


class LightGBMError(Exception):
    """Raised where the reference would Log::Fatal (log.h:93)."""


class Log:
    @staticmethod
    def set_level(verbose: int) -> None:
        # reference verbosity semantics: <0 fatal-only, 0 warning, 1 info, >1 debug
        if verbose < 0:
            _logger.setLevel(logging.CRITICAL)
        elif verbose == 0:
            _logger.setLevel(logging.WARNING)
        elif verbose == 1:
            _logger.setLevel(logging.INFO)
        else:
            _logger.setLevel(logging.DEBUG)

    @staticmethod
    def debug(msg: str, *args) -> None:
        _logger.debug(msg, *args)

    @staticmethod
    def info(msg: str, *args) -> None:
        _logger.info(msg, *args)

    @staticmethod
    def warning(msg: str, *args) -> None:
        _logger.warning(msg, *args)

    @staticmethod
    def fatal(msg: str, *args) -> None:
        raise LightGBMError(msg % args if args else msg)
