"""Logging factory.

Counterpart of ``crowdllama_tpu/logutil.py``: one place that builds the
application logger: colored console output (when stderr is a terminal),
an ``[app]`` field on every record, INFO level unless verbose, and no
propagation to the root logger, so a record prints once.
"""

from __future__ import annotations

import logging
import sys

_COLORS = {
    logging.DEBUG: "\x1b[36m",
    logging.INFO: "\x1b[32m",
    logging.WARNING: "\x1b[33m",
    logging.ERROR: "\x1b[31m",
    logging.CRITICAL: "\x1b[35m",
}
_RESET = "\x1b[0m"


class _ConsoleFormatter(logging.Formatter):
    def __init__(self, app: str, color: bool):
        super().__init__()
        self.app = app
        self.color = color

    def format(self, record: logging.LogRecord) -> str:
        level = record.levelname
        if self.color:
            level = f"{_COLORS.get(record.levelno, '')}{level}{_RESET}"
        base = (f"{self.formatTime(record, '%H:%M:%S')} {level} "
                f"[{self.app}] {record.name}: {record.getMessage()}")
        if record.exc_info:
            base += "\n" + self.formatException(record.exc_info)
        return base


def new_app_logger(app: str, verbose: bool = False) -> logging.Logger:
    """Build (or rebuild) the logger ``app`` for one application component:
    DEBUG when ``verbose``, else INFO; one stderr handler."""
    logger = logging.getLogger(app)
    logger.setLevel(logging.DEBUG if verbose else logging.INFO)
    logger.propagate = False
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(_ConsoleFormatter(app, color=sys.stderr.isatty()))
        logger.addHandler(handler)
    return logger
