"""Colored singleton logger (counterpart of ``howl_tpu/utils/logger.py``;
capability parity: howl/utils/logger.py:58)."""

from __future__ import annotations

import logging
import sys

_COLORS = {
    logging.DEBUG: "\033[36m",  # cyan
    logging.INFO: "\033[32m",  # green
    logging.WARNING: "\033[33m",  # yellow
    logging.ERROR: "\033[31m",  # red
    logging.CRITICAL: "\033[35m",  # magenta
}
_RESET = "\033[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        msg = super().format(record)
        if sys.stderr.isatty():
            return f"{_COLORS.get(record.levelno, '')}{msg}{_RESET}"
        return msg


class Logger:
    """Process-wide logger with heading/info/debug helpers."""

    NAME = "howl_tpu_torch"
    _logger: logging.Logger = None

    @classmethod
    def init(cls, level: int = logging.INFO) -> logging.Logger:
        logger = logging.getLogger(cls.NAME)
        if not logger.handlers:
            handler = logging.StreamHandler(sys.stderr)
            handler.setFormatter(_ColorFormatter("%(asctime)s %(levelname)s %(message)s", "%H:%M:%S"))
            logger.addHandler(handler)
            logger.propagate = False
        logger.setLevel(level)
        cls._logger = logger
        return logger

    @classmethod
    def get(cls) -> logging.Logger:
        if cls._logger is None:
            cls.init()
        return cls._logger

    @classmethod
    def heading(cls, msg: str):
        bar = "=" * max(8, len(str(msg)))
        cls.get().info(bar)
        cls.get().info(msg)
        cls.get().info(bar)

    @classmethod
    def info(cls, msg):
        cls.get().info(msg)

    @classmethod
    def debug(cls, msg):
        cls.get().debug(msg)

    @classmethod
    def warning(cls, msg):
        cls.get().warning(msg)

    @classmethod
    def error(cls, msg):
        cls.get().error(msg)
