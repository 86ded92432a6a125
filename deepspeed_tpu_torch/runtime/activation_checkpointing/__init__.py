from .checkpointing import (CheckpointFunction, checkpoint,
                            checkpoint_with_generator, configure,
                            get_partition_policy, is_configured,
                            model_parallel_rng, reset)
