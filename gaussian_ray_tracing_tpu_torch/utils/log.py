"""Structured logging (counterpart of gaussian_ray_tracing_tpu/utils/log.py,
which replaces the reference's std::cout prints and the OptiX context log
callback, src/Utility.h:9-13)."""

from __future__ import annotations

import json
import logging
import sys
import time


def get_logger(name: str = "grt") -> logging.Logger:
    """The named logger at INFO, with one stderr handler
    ("[time LEVEL name] message") added the first time it is asked for."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter("[%(asctime)s %(levelname)s %(name)s] %(message)s"))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
    return logger


def log_metrics(metrics: dict, step: int | None = None, stream=None):
    """One JSON line per metrics record (machine-parsable observability):
    {"ts": unix time, "step": step (if given), **metrics}, written to
    `stream` (default sys.stdout) and flushed."""
    stream = sys.stdout if stream is None else stream
    rec = {"ts": time.time()}
    if step is not None:
        rec["step"] = step
    rec.update(metrics)
    stream.write(json.dumps(rec) + "\n")
    stream.flush()
