"""Logging setup — the seconohe.initialize_logger equivalent (twin of
``float_tpu.utils.logging``).

A root logger for the port with per-module children; verbosity via the
FLOAT_TORCH_DEBUG environment variable (1 = info, 2 = debug, 3 = below
debug).
"""
from __future__ import annotations

import logging
import os

ROOT_NAME = "float_torch"


def initialize_logger(name: str = ROOT_NAME) -> logging.Logger:
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    handler = logging.StreamHandler()
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(name)s %(levelname)s: %(message)s"))
    logger.addHandler(handler)
    level = {"": logging.WARNING, "1": logging.INFO,
             "2": logging.DEBUG, "3": logging.DEBUG - 1}.get(
        os.environ.get("FLOAT_TORCH_DEBUG", ""), logging.WARNING)
    logger.setLevel(level)
    return logger


def get_logger(module: str) -> logging.Logger:
    return logging.getLogger(f"{ROOT_NAME}.{module}")
