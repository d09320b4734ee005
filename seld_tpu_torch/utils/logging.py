"""Timestamped file and stdout logging (counterpart:
seld_tpu/utils/logging.py).

Every module of the package logs under `logging.getLogger(__name__)`, a
child of the package logger `seld_tpu_torch`, so the two handlers set up
here catch them all. Records also propagate to the root logger, which has
no handler of the package's (a capture such as pytest's `caplog` listens
there), so no line is printed twice.
"""

from __future__ import annotations

import logging
import os
import sys
from datetime import datetime

LOGGER_NAME = "seld_tpu_torch"
FORMAT = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"
DATE_FORMAT = "%Y-%m-%d %H:%M:%S"


class _Stdout(logging.StreamHandler):
    """A handler on whatever sys.stdout is when a record is emitted, so that
    a redirect of stdout (contextlib.redirect_stdout, a test's capture)
    takes the log lines with the printed ones, and a closed capture is
    never written to."""

    def __init__(self):
        super().__init__(sys.stdout)

    @property
    def stream(self):
        return sys.stdout

    @stream.setter
    def stream(self, value):
        pass


def get_logger() -> logging.Logger:
    return logging.getLogger(LOGGER_NAME)


def close_logging() -> None:
    """Remove and close the handlers an earlier setup_logging added; any
    handler a caller attached stays."""
    logger = get_logger()
    for handler in [h for h in logger.handlers if getattr(h, "_seld_setup", False)]:
        logger.removeHandler(handler)
        handler.close()


def setup_logging(log_dir: str = "logs", experiment_name: str = "seld_tpu_torch"):
    """The package logger at INFO with a file handler on
    <log_dir>/<experiment_name>_<YYYYmmdd_HHMMSS>.log and a stdout handler.
    A repeated setup first removes and closes the handlers of the last one,
    so lines are not duplicated and files do not stay open.

    Returns (logger, log_file_path)."""
    os.makedirs(log_dir, exist_ok=True)
    timestamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    log_file = os.path.join(log_dir, f"{experiment_name}_{timestamp}.log")

    close_logging()
    logger = get_logger()
    logger.setLevel(logging.INFO)
    formatter = logging.Formatter(FORMAT, datefmt=DATE_FORMAT)
    for handler in (logging.FileHandler(log_file), _Stdout()):
        handler.setLevel(logging.INFO)
        handler.setFormatter(formatter)
        handler._seld_setup = True
        logger.addHandler(handler)
    return logger, log_file
