"""Logging (reference analog: ``gst/nnstreamer/nnstreamer_log.{c,h}``
``ml_logi/w/e/f`` macros). One package logger, env-configurable level via
``NNS_TPU_DEBUG`` (reference uses ``GST_DEBUG`` levels)."""
from __future__ import annotations

import logging
import os

logger = logging.getLogger("nnstreamer_tpu_torch")

_LEVELS = {"0": logging.ERROR, "1": logging.WARNING, "2": logging.INFO,
           "3": logging.DEBUG, "4": logging.DEBUG}

_level = os.environ.get("NNS_TPU_DEBUG", "1")
logger.setLevel(_LEVELS.get(_level, logging.WARNING))
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
    logger.addHandler(_h)
