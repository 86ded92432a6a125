"""The port's ops.  KERNELS lists every hand-written CUDA kernel: its
wrapper (which launches it and counts the launches), its plain PyTorch
twin, its source and the TPU kernel it replaces."""

from typing import Callable, NamedTuple

from . import collective_matmul
from .activations import (bias_dropout_residual, bias_gelu, dropout, gelu,
                          gelu_exact)
from .collective_matmul import (fcm_ag_step_cuda, fcm_ag_step_reference,
                                fcm_ag_step_t_cuda, fcm_ag_step_t_reference,
                                fcm_all_gather, fcm_qgz_reduce_scatter_inner,
                                fcm_reduce_scatter, fcm_rs_collect_cuda,
                                fcm_rs_collect_reference, fcm_rs_producer_cuda,
                                fcm_rs_producer_reference, fcm_tile_ag_cuda,
                                fcm_tile_ag_reference, fcm_tile_ag_t_cuda,
                                fcm_tile_ag_t_reference, fcm_tile_rs_cuda,
                                fcm_tile_rs_reference, fused_allgather_matmul,
                                fused_matmul_reduce_scatter)
from .flash_attention import (DEFAULT_MASK_VALUE, dropout_keep_mask,
                              flash_attention, flash_attention_bwd,
                              flash_attention_bwd_dkdv_cuda,
                              flash_attention_bwd_dq_cuda,
                              flash_attention_bwd_reference,
                              flash_attention_cuda, mha_reference)
from .fused_cross_entropy import fused_linear_cross_entropy
from .normalize import (fused_layer_norm, layer_norm_bwd_cuda,
                        layer_norm_bwd_reference, layer_norm_cuda,
                        layer_norm_reference)
from .quant import (QuantizedWeight, dequant, dequant_matmul_reference,
                    fused_dequant_matmul, matmul_maybe_int8)
from . import sparse_attention
from .sparse_attention.block_sparse_flash import (
    block_sparse_flash_bwd_dkdv_cuda, block_sparse_flash_bwd_dq_cuda,
    block_sparse_flash_bwd_reference, block_sparse_flash_fwd_cuda,
    block_sparse_flash_fwd_reference)
from .transformer import DeepSpeedTransformerConfig, DeepSpeedTransformerLayer


class Kernel(NamedTuple):
    name: str
    wrapper: Callable   # launches the kernel; carries `.launches`
    plain: Callable     # the plain PyTorch version of the same function
    source: str         # path in the repository
    replaces: str       # file:line of the TPU (Pallas) kernel's wrapper


KERNELS = (
    Kernel("layer_norm_fwd", layer_norm_cuda, layer_norm_reference,
           "deepspeed_tpu_torch/csrc/layer_norm.cu",
           "deepspeed_tpu/ops/normalize.py:67"),
    Kernel("flash_attention_fwd", flash_attention_cuda, mha_reference,
           "deepspeed_tpu_torch/csrc/flash_attention_fwd.cu",
           "deepspeed_tpu/ops/flash_attention.py:456"),
    Kernel("dequant_matmul", fused_dequant_matmul, dequant_matmul_reference,
           "deepspeed_tpu_torch/csrc/dequant_matmul.cu",
           "deepspeed_tpu/ops/quant.py:89"),
    Kernel("layer_norm_bwd", layer_norm_bwd_cuda, layer_norm_bwd_reference,
           "deepspeed_tpu_torch/csrc/layer_norm_bwd.cu",
           "deepspeed_tpu/ops/normalize.py:126"),
    # kernel E: two launches, one plain twin that returns dq, dk and dv
    Kernel("flash_attention_bwd_dkdv", flash_attention_bwd_dkdv_cuda,
           flash_attention_bwd_reference,
           "deepspeed_tpu_torch/csrc/flash_attention_bwd.cu",
           "deepspeed_tpu/ops/flash_attention.py:717"),
    Kernel("flash_attention_bwd_dq", flash_attention_bwd_dq_cuda,
           flash_attention_bwd_reference,
           "deepspeed_tpu_torch/csrc/flash_attention_bwd.cu",
           "deepspeed_tpu/ops/flash_attention.py:717"),
    Kernel("block_sparse_flash_fwd", block_sparse_flash_fwd_cuda,
           block_sparse_flash_fwd_reference,
           "deepspeed_tpu_torch/csrc/block_sparse_flash_fwd.cu",
           "deepspeed_tpu/ops/sparse_attention/block_sparse_flash.py:227"),
    # kernel G: two launches, one plain twin that returns dq, dk and dv
    Kernel("block_sparse_flash_bwd_dq", block_sparse_flash_bwd_dq_cuda,
           block_sparse_flash_bwd_reference,
           "deepspeed_tpu_torch/csrc/block_sparse_flash_bwd.cu",
           "deepspeed_tpu/ops/sparse_attention/block_sparse_flash.py:278"),
    Kernel("block_sparse_flash_bwd_dkdv", block_sparse_flash_bwd_dkdv_cuda,
           block_sparse_flash_bwd_reference,
           "deepspeed_tpu_torch/csrc/block_sparse_flash_bwd.cu",
           "deepspeed_tpu/ops/sparse_attention/block_sparse_flash.py:278"),
    # kernel H: the three tile products of the per-tile route
    Kernel("fcm_tile_ag", fcm_tile_ag_cuda, fcm_tile_ag_reference,
           "deepspeed_tpu_torch/csrc/fcm_tile.cu",
           "deepspeed_tpu/ops/collective_matmul.py:398"),
    Kernel("fcm_tile_ag_t", fcm_tile_ag_t_cuda, fcm_tile_ag_t_reference,
           "deepspeed_tpu_torch/csrc/fcm_tile.cu",
           "deepspeed_tpu/ops/collective_matmul.py:398"),
    Kernel("fcm_tile_rs", fcm_tile_rs_cuda, fcm_tile_rs_reference,
           "deepspeed_tpu_torch/csrc/fcm_tile.cu",
           "deepspeed_tpu/ops/collective_matmul.py:398"),
    # kernel I: the fused all-gather-matmul's step, forward and transposed
    Kernel("fcm_ag_step", fcm_ag_step_cuda, fcm_ag_step_reference,
           "deepspeed_tpu_torch/csrc/fcm_ag_matmul.cu",
           "deepspeed_tpu/ops/collective_matmul.py:587"),
    Kernel("fcm_ag_step_t", fcm_ag_step_t_cuda, fcm_ag_step_t_reference,
           "deepspeed_tpu_torch/csrc/fcm_ag_matmul.cu",
           "deepspeed_tpu/ops/collective_matmul.py:587"),
    # kernel J: the producer with the quantize epilogue, and the collect
    Kernel("fcm_rs_producer", fcm_rs_producer_cuda, fcm_rs_producer_reference,
           "deepspeed_tpu_torch/csrc/fcm_matmul_rs.cu",
           "deepspeed_tpu/ops/collective_matmul.py:692"),
    Kernel("fcm_rs_collect", fcm_rs_collect_cuda, fcm_rs_collect_reference,
           "deepspeed_tpu_torch/csrc/fcm_matmul_rs.cu",
           "deepspeed_tpu/ops/collective_matmul.py:692"),
)


def reset_launch_counts() -> None:
    """Zero every wrapper's launch count and, where it has one, its count
    of realigned operands."""
    for k in KERNELS:
        k.wrapper.launches = 0
        if hasattr(k.wrapper, "realigned"):
            k.wrapper.realigned = 0


def launch_counts() -> dict:
    return {k.name: k.wrapper.launches for k in KERNELS}


def realign_counts() -> dict:
    """Operands the wrappers with a tensor-core route (kernels B, E, F, G,
    H's, I's and J's product launches, and C's prefill route) copied to meet
    its 16-byte rule, by kernel."""
    return {k.name: k.wrapper.realigned for k in KERNELS
            if hasattr(k.wrapper, "realigned")}
