from .gpt2 import GPT2Config, GPT2Model
from .convert import (gpt2_params_from_jax, gpt2_params_to_jax,
                      ranked_from_stacked, stacked_from_ranked)
