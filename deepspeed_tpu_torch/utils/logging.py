"""Logging for the PyTorch port (counterpart of deepspeed_tpu/utils/logging.py).

The port runs in one process per card and this slice has no process
group, so `log_dist` logs from rank 0, the only rank there is.  Logs go
to stderr, so that a script's standard output holds only what it prints.
"""

import logging
import sys

def _create_logger(name="DeepSpeedTorch", level=logging.INFO):
    logger_ = logging.getLogger(name)
    logger_.setLevel(level)
    logger_.propagate = False
    if not logger_.handlers:
        formatter = logging.Formatter(
            "[%(asctime)s] [%(levelname)s] [%(filename)s:%(lineno)d:%(funcName)s] "
            "%(message)s")
        handler = logging.StreamHandler(stream=sys.stderr)
        handler.setFormatter(formatter)
        logger_.addHandler(handler)
    return logger_


logger = _create_logger()


def log_dist(message, ranks=None, level=logging.INFO):
    """Log from the listed ranks only; None means rank 0 and -1 in the list
    means every rank.  Single-process: this process is rank 0."""
    my_rank = 0
    ranks = ranks or [0]
    if my_rank in ranks or -1 in ranks:
        logger.log(level, f"[Rank {my_rank}] {message}")
