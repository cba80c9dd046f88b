"""ANSI-coloured console + file logger (the port's copy of
``ihpr_tpu.engine.logger``).

Reference: ``common/logger.py:colorlogger`` (logging to
``output/log/{train,test}_logs.txt`` + a coloured console).
"""

from __future__ import annotations

import logging
import os
import sys

_COLORS = {
    logging.DEBUG: "\033[37m",
    logging.INFO: "\033[92m",
    logging.WARNING: "\033[93m",
    logging.ERROR: "\033[91m",
}
_RESET = "\033[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        msg = super().format(record)
        if sys.stdout.isatty():
            return f"{_COLORS.get(record.levelno, '')}{msg}{_RESET}"
        return msg


def colorlogger(log_dir: str | None = None, log_name: str = "train_logs.txt") -> logging.Logger:
    # The cache key includes the directory: a second Trainer with another
    # output_dir must not keep appending to the first one's file.
    logger = logging.getLogger(f"ihpr_tpu_torch.{log_dir}.{log_name}")
    logger.setLevel(logging.INFO)
    logger.propagate = False
    if logger.handlers:
        return logger
    fmt = "%(asctime)s %(message)s"
    console = logging.StreamHandler(sys.stdout)
    console.setFormatter(_ColorFormatter(fmt, datefmt="%H:%M:%S"))
    logger.addHandler(console)
    if log_dir and _process_index() == 0:
        # The file handler on process 0 only: processes appending to one
        # shared log would interleave mid-line.
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(log_dir, log_name))
        fh.setFormatter(logging.Formatter(fmt))
        logger.addHandler(fh)
    return logger


def _process_index() -> int:
    """This process's rank in an initialized ``torch.distributed`` group, else 0."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0
