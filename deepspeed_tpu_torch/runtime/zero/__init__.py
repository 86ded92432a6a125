from .partition import (ZeroPartitioner, resolve_hpz_axes,
                        zero_partition_spec)
from .api import GatheredParameters, Init
from .tiling import TiledLinear
