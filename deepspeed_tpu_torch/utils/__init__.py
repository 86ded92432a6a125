from .logging import logger, log_dist
