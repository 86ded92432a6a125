from .partition import ZeroPartitioner
