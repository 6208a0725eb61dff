"""Logging: one package logger with separate file and console levels.

A copy of the logger half of `waveformer_tpu/utils/logger.py` (reference
`Logger`, `lib/utils/tools/logger.py:31-204` via
`utils/logger_setup.py:12-74`). The TensorBoard writer comes with the
training entry points.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

# --------------------------------------------------------------------------- #
# file + console logger
# --------------------------------------------------------------------------- #

_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}

_DEFAULT_FORMAT = "%(asctime)s %(levelname)-7s [%(filename)s:%(lineno)d] %(message)s"

_logger: Optional[logging.Logger] = None


def setup_logging(
    log_file: str = "./logs/training.log",
    file_level: str = "debug",
    console_level: str = "info",
    write_to_file: bool = True,
    write_to_console: bool = True,
    rewrite: bool = False,
    fmt: str = _DEFAULT_FORMAT,
    name: str = "waveformer_tpu_torch",
) -> logging.Logger:
    """Configure the package logger (reference `setup_logging`,
    `utils/logger_setup.py:12-74`)."""
    global _logger
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    for h in logger.handlers:
        h.close()
    logger.handlers.clear()
    logger.propagate = False
    formatter = logging.Formatter(fmt)
    if write_to_console:
        ch = logging.StreamHandler(sys.stdout)
        ch.setLevel(_LEVELS[console_level])
        ch.setFormatter(formatter)
        logger.addHandler(ch)
    if write_to_file:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        fh = logging.FileHandler(log_file, mode="w" if rewrite else "a")
        fh.setLevel(_LEVELS[file_level])
        fh.setFormatter(formatter)
        logger.addHandler(fh)
    _logger = logger
    return logger


def get_logger(name: str = "waveformer_tpu_torch") -> logging.Logger:
    """(reference `get_logger`)."""
    global _logger
    if _logger is None:
        _logger = setup_logging(write_to_file=False)
    return _logger


def setup_logging_from_config(cfg) -> logging.Logger:
    """Wire a `waveformer_tpu_torch.config.LoggingConfig`."""
    if not cfg.enabled:
        return setup_logging(write_to_file=False, write_to_console=False)
    return setup_logging(
        log_file=cfg.log_file,
        file_level=cfg.log_level_file,
        console_level=cfg.log_level_console,
        write_to_file=cfg.write_to_file,
        write_to_console=cfg.write_to_console,
        rewrite=cfg.rewrite_log,
    )
