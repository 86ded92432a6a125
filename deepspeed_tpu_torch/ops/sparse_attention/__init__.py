from .sparsity_config import (BigBirdSparsityConfig,
                              BSLongformerSparsityConfig,
                              DenseSparsityConfig, FixedSparsityConfig,
                              SparsityConfig, VariableSparsityConfig)
from .sparse_self_attention import (SparseSelfAttention,
                                    layout_to_gather_indices)
from .block_sparse_flash import (block_sparse_flash_attention,
                                 layout_gather)
from .sparse_attention_utils import (extend_position_embedding,
                                     pad_to_block_size,
                                     unpad_sequence_output)
from .matmul import MatMul, Softmax, block_coords
from .bert_sparse_self_attention import BertSparseSelfAttention
