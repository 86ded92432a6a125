from .aio_handle import (AsyncIOHandle, get_aio_lib, handle_kwargs,
                         io_uring_available, resolve_backend)
from .async_swapper import AsyncTensorSwapper, InflightTensorWrite
from .optimizer_swapper import (NVMeOffloadOptimizer,
                                create_nvme_offload_optimizer)
from .partitioned_param_swapper import (InflightGroupRead,
                                        PartitionedParamSwapper)
from .utils import SwapBuffer, SwapBufferPool, aligned_empty
