"""Timestamped file logger (counterpart of the JAX ``utils/logging.py``)."""

from __future__ import annotations

import datetime
import logging
import os


def get_logger(logdir: str, name: str = "tss_torch") -> logging.Logger:
    """A logger writing ``<logdir>/run_<timestamp>.log``, one line per
    record as ``<asctime> <level> <message>``."""
    logger = logging.getLogger(name)
    os.makedirs(logdir, exist_ok=True)
    ts = str(datetime.datetime.now()).split(".")[0]
    ts = ts.replace(" ", "_").replace(":", "_").replace("-", "_")
    handler = logging.FileHandler(os.path.join(logdir, f"run_{ts}.log"))
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s %(message)s"))
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    return logger
