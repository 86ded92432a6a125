"""Logging for the PyTorch port (counterpart of deepspeed_tpu/utils/logging.py).

`log_dist` logs from the listed ranks: a process's rank is its rank in
the torch.distributed world when one is up (one process per card,
utils/distributed.py), else 0.  Logs go to stderr, so that a script's
standard output holds only what it prints.
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


def _process_rank() -> int:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def log_dist(message, ranks=None, level=logging.INFO):
    """Log from the listed ranks only; None means rank 0 and -1 in the list
    means every rank."""
    my_rank = _process_rank()
    ranks = ranks or [0]
    if my_rank in ranks or -1 in ranks:
        logger.log(level, f"[Rank {my_rank}] {message}")
