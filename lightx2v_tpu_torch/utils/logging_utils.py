"""stdlib logging shim."""

from __future__ import annotations

import logging
import os
import sys

_FMT = "%(asctime)s | %(levelname)-7s | %(name)s:%(lineno)d - %(message)s"


def get_logger(name: str = "lightx2v_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FMT, datefmt="%H:%M:%S"))
        logger.addHandler(handler)
        logger.setLevel(os.environ.get("LIGHTX2V_LOG_LEVEL", "INFO").upper())
        logger.propagate = False
    return logger


logger = get_logger()
