"""Structured logging with a SUCCESS level (port of ``audax/core/logging.py``,
own copy).

The reference installs a colorlog logger with a custom SUCCESS level (25) and
monkey-patches ``logging.Logger`` (reference: .charles/music2midi/logger_utils.py:4-30,
.charles/spectrogram.py:19-45). We provide the same ergonomic surface —
``log.success("...")`` — with stdlib-only ANSI coloring, without global
monkey-patching (the method is added once, guarded).
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

SUCCESS = 25

_COLORS = {
    logging.DEBUG: "\x1b[36m",     # cyan
    logging.INFO: "\x1b[32m",      # green
    SUCCESS: "\x1b[1;32m",         # bold green
    logging.WARNING: "\x1b[33m",   # yellow
    logging.ERROR: "\x1b[31m",     # red
    logging.CRITICAL: "\x1b[1;41m",
}
_RESET = "\x1b[0m"


class _ColorFormatter(logging.Formatter):
    def __init__(self, use_color: bool) -> None:
        super().__init__("%(asctime)s %(levelname)-8s %(name)s: %(message)s",
                         datefmt="%H:%M:%S")
        self._use_color = use_color

    def format(self, record: logging.LogRecord) -> str:
        text = super().format(record)
        if self._use_color:
            color = _COLORS.get(record.levelno, "")
            return f"{color}{text}{_RESET}" if color else text
        return text


def _install_success_level() -> None:
    if logging.getLevelName(SUCCESS) != "SUCCESS":
        logging.addLevelName(SUCCESS, "SUCCESS")
    if not hasattr(logging.Logger, "success"):
        def success(self: logging.Logger, msg: str, *args, **kwargs) -> None:
            if self.isEnabledFor(SUCCESS):
                self._log(SUCCESS, msg, args, **kwargs)
        logging.Logger.success = success  # type: ignore[attr-defined]


def get_logger(name: str = "audax_torch", level: Optional[int] = None) -> logging.Logger:
    """Return a configured logger; idempotent per name."""
    _install_success_level()
    logger = logging.getLogger(name)
    if not getattr(logger, "_audax_configured", False):
        handler = logging.StreamHandler(sys.stderr)
        use_color = sys.stderr.isatty() and os.environ.get("NO_COLOR") is None
        handler.setFormatter(_ColorFormatter(use_color))
        logger.addHandler(handler)
        logger.propagate = False
        env_level = os.environ.get("AUDAX_LOG_LEVEL", "INFO").upper()
        logger.setLevel(level if level is not None else env_level)
        logger._audax_configured = True  # type: ignore[attr-defined]
    return logger
