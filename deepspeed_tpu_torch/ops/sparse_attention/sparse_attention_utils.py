"""Sparse-attention integration helpers (counterpart of
deepspeed_tpu/ops/sparse_attention/sparse_attention_utils.py): pad and
unpad sequences to the block size, and grow a trained position-embedding
table for longer sparse-attention sequences.

`DeepSpeedTransformerConfig.sparsity_config` routes a layer's attention
through SparseSelfAttention (ops/transformer.py), so a model built on the
layer becomes block-sparse by its config alone.
"""

import torch
import torch.nn.functional as F


def pad_to_block_size(block: int, input_ids, pad_token_id: int,
                      attention_mask=None):
    """Right-pad [B, S] ids (and mask) so that the block size divides S;
    returns (pad_len, ids, mask) like the reference's pad_to_block_size."""
    seq_len = input_ids.shape[1]
    pad_len = (block - seq_len % block) % block
    if pad_len == 0:
        return 0, input_ids, attention_mask
    ids = F.pad(input_ids, (0, pad_len), value=pad_token_id)
    if attention_mask is not None:
        attention_mask = F.pad(attention_mask, (0, pad_len), value=0)
    return pad_len, ids, attention_mask


def unpad_sequence_output(pad_len: int, sequence_output):
    """Drop the padding added by pad_to_block_size."""
    if pad_len == 0:
        return sequence_output
    return sequence_output[:, :-pad_len]


def extend_position_embedding(params: dict, new_max_positions: int):
    """Grow a checkpoint's position-embedding table ("wpe", e.g. a
    GPT2Model state dict) to new_max_positions rows by tiling the trained
    rows, as the reference does.  Returns a new dict; new_max_positions
    must be a multiple of the current table length."""
    if "wpe" not in params:
        raise ValueError("params has no 'wpe' position-embedding table")
    wpe = params["wpe"]
    cur = wpe.shape[0]
    if new_max_positions % cur:
        raise ValueError(
            f"new_max_positions {new_max_positions} must be a multiple of "
            f"the trained length {cur} (reference semantics)")
    out = dict(params)
    out["wpe"] = torch.as_tensor(wpe).repeat(new_max_positions // cur, 1)
    return out
