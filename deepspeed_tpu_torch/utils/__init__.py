from .logging import logger, log_dist
from .distributed import init_distributed, mpi_discovery
