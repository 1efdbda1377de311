"""Logging with elapsed-time formatting.

Parity target: happypose/toolbox/utils/logging.py:22-45 (the port's own
copy of `happypose_tpu/utils/logging.py`)."""

from __future__ import annotations

import logging
import time

_START = time.time()


class ElapsedFormatter(logging.Formatter):
    def format(self, record):
        elapsed = time.time() - _START
        record.elapsed = f"{elapsed:10.3f}s"
        return super().format(record)


def get_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            ElapsedFormatter("[%(elapsed)s][%(name)s] %(message)s")
        )
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


def set_logging_level(level: str) -> None:
    logging.getLogger("happypose_tpu_torch").setLevel(level.upper())
