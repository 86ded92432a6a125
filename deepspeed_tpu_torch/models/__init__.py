from .gpt2 import GPT2Config, GPT2Model
from .convert import (gpt2_flat_from_tree, gpt2_params_from_jax,
                      gpt2_params_to_jax, gpt2_tree_from_flat,
                      ranked_from_stacked, stacked_from_ranked)
