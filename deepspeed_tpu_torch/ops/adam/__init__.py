from .cpu_adam import (DeepSpeedCPUAdam, adam_step_buffers, adam_step_plain,
                       native_lib, num_threads)
