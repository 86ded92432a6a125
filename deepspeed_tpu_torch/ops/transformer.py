"""The transformer block (counterpart of deepspeed_tpu/ops/transformer.py).

`DeepSpeedTransformerLayer` is an `nn.Module` whose parameters carry the
reference's names and the JAX package's [in, out] layout (`x @ W`), so a
JAX checkpoint maps over by copying.  Ported: the pre-LN layer with a
dense FFN and causal or bidirectional attention, for training and serving:
LN (kernels A / D) -> QKV matmul -> flash attention (kernels B / E) ->
out-proj + bias-dropout-residual -> LN -> bias-gelu MLP +
bias-dropout-residual.  Attention dropout runs inside kernel B
(`attn_dropout_impl="kernel"`, the reference's probability dropout) or on
the attention output (`"ctx"`).  A layer with a `sparsity_config` routes
its attention through `SparseSelfAttention` (kernels F / G) instead, with
dropout on the attention output whatever `attn_dropout_impl` says, as the
JAX layer does.  Parameters are fp32 and trainable; every
use casts them to the compute dtype, so autograd returns fp32 grads.
Matmul weights may be replaced by int8 `QuantizedWeight`s (serving), which
route through kernel C.
"""

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from .activations import bias_dropout_residual, bias_gelu, dropout
from .flash_attention import flash_attention
from .normalize import fused_layer_norm
from .quant import matmul_maybe_int8
from .sparse_attention import SparseSelfAttention


@dataclass
class DeepSpeedTransformerConfig:
    """Model-shape and dropout fields of deepspeed_tpu's
    DeepSpeedTransformerConfig (the TPU block sizes, attention impl and
    layout switches are not carried over, nor fp16: the kernels take bf16
    and fp32)."""
    hidden_size: int = -1
    intermediate_size: int = -1
    heads: int = -1
    attn_dropout_ratio: float = 0.1
    hidden_dropout_ratio: float = 0.1
    num_hidden_layers: int = -1
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-5
    bf16: bool = True
    pre_layer_norm: bool = True
    causal: bool = False
    # "gelu_new"/"gelu_pytorch_tanh" = tanh approximation; "gelu" = erf
    activation: str = "gelu_new"
    # "kernel": probability dropout inside the flash kernel (the
    # reference's semantics); "ctx": dropout on the attention output
    attn_dropout_impl: str = "kernel"
    # a SparsityConfig routes the layer's attention through
    # SparseSelfAttention (block-sparse, kernels F / G)
    sparsity_config: Optional[object] = None

    @property
    def gelu_approximate(self) -> bool:
        if self.activation in ("gelu_new", "gelu_pytorch_tanh",
                               "gelu_python", "gelu_fast"):
            return True
        if self.activation == "gelu":
            return False
        raise ValueError(f"unsupported activation {self.activation!r} — "
                         f"gelu variants only")

    def __post_init__(self):
        if self.intermediate_size == -1 and self.hidden_size != -1:
            self.intermediate_size = 4 * self.hidden_size
        if self.attn_dropout_impl not in ("kernel", "ctx"):
            raise ValueError(f"attn_dropout_impl must be 'kernel' or 'ctx', "
                             f"got {self.attn_dropout_impl!r}")

    @property
    def dtype(self):
        return torch.bfloat16 if self.bf16 else torch.float32


class DeepSpeedTransformerLayer(nn.Module):
    """Pre-LN transformer layer.  Parameters (fp32 at creation):
    attn_qkvw [H, 3H], attn_qkvb [3H], attn_ow [H, H], attn_ob [H],
    norm_w/norm_b [H] (pre-attention LN), attn_nw/attn_nb [H] (pre-MLP LN),
    inter_w [H, I], inter_b [I], output_w [I, H], output_b [H]."""

    MATMUL_WEIGHTS = ("attn_qkvw", "attn_ow", "inter_w", "output_w")
    LN_PARAMS = ("norm_w", "norm_b", "attn_nw", "attn_nb")

    def __init__(self, config: DeepSpeedTransformerConfig):
        super().__init__()
        if not config.pre_layer_norm:
            raise NotImplementedError(
                "post-LN layers are not ported yet; this slice runs the "
                "pre-LN layer GPT-2 uses")
        self.config = config
        self.sparse_attn = (None if config.sparsity_config is None
                            else SparseSelfAttention(config.sparsity_config))
        for name, shape in self.param_shapes(config).items():
            self.register_parameter(name, nn.Parameter(torch.zeros(shape)))
        for name in ("norm_w", "attn_nw"):
            getattr(self, name).data.fill_(1.0)

    @staticmethod
    def param_shapes(config: DeepSpeedTransformerConfig) -> dict:
        h, inter = config.hidden_size, config.intermediate_size
        return {
            "attn_qkvw": (h, 3 * h), "attn_qkvb": (3 * h,),
            "attn_ow": (h, h), "attn_ob": (h,),
            "norm_w": (h,), "norm_b": (h,),
            "attn_nw": (h,), "attn_nb": (h,),
            "inter_w": (h, inter), "inter_b": (inter,),
            "output_w": (inter, h), "output_b": (h,),
        }

    @staticmethod
    def param_partition_specs() -> dict:
        """The JAX layer's Megatron-style tensor-parallel specs over the
        "model" axis (qkv / inter column-split, out / output row-split), in
        runtime/zero/partition.py's PartitionSpec: ZeRO-3 cuts each leaf
        along a dimension they leave free, as the JAX package does."""
        from ..parallel.mesh import MODEL_AXIS
        from ..runtime.zero.partition import PartitionSpec as P
        return {"attn_qkvw": P(None, MODEL_AXIS), "attn_qkvb": P(MODEL_AXIS),
                "attn_ow": P(MODEL_AXIS, None), "attn_ob": P(),
                "norm_w": P(), "norm_b": P(), "attn_nw": P(), "attn_nb": P(),
                "inter_w": P(None, MODEL_AXIS), "inter_b": P(MODEL_AXIS),
                "output_w": P(MODEL_AXIS, None), "output_b": P()}

    @torch.no_grad()
    def init_params(self, generator: torch.Generator):
        """Matmul weights ~ N(0, initializer_range), biases 0, LN 1/0."""
        std = self.config.initializer_range
        for name, param in self.named_parameters():
            if name in self.MATMUL_WEIGHTS:
                param.normal_(0.0, std, generator=generator)
            elif name in ("norm_w", "attn_nw"):
                param.fill_(1.0)
            else:
                param.zero_()

    # -- blocks shared with the inference twin (transformer_inference.py) --
    def qkv_heads(self, x):
        """LN + QKV projection of x [B, S, H] -> q, k, v [B, heads, S, d]
        (views into one [B, S, 3H] product)."""
        cfg = self.config
        b, s, _ = x.shape
        attn_in = fused_layer_norm(x, self.norm_w, self.norm_b,
                                   cfg.layer_norm_eps)
        qkv = matmul_maybe_int8(attn_in, self.attn_qkvw) + \
            self.attn_qkvb.to(attn_in.dtype)

        def to_heads(t):
            return t.view(b, s, cfg.heads, -1).transpose(1, 2)
        q, k, v = qkv.split(cfg.hidden_size, dim=-1)
        return to_heads(q), to_heads(k), to_heads(v)

    def attn_out_mlp(self, ctx, residual, generator=None,
                     deterministic: bool = True):
        """Out-projection of ctx [B, heads, S, d] + bias-dropout-residual,
        then the pre-LN bias-gelu MLP + bias-dropout-residual; the two
        hidden dropouts draw from `generator` unless deterministic."""
        cfg = self.config
        rate = cfg.hidden_dropout_ratio
        b, heads, s, d = ctx.shape
        ctx = ctx.transpose(1, 2).reshape(b, s, heads * d)
        attn_out = bias_dropout_residual(
            matmul_maybe_int8(ctx, self.attn_ow), self.attn_ob.to(ctx.dtype),
            residual, rate, generator, deterministic)
        mlp_in = fused_layer_norm(attn_out, self.attn_nw, self.attn_nb,
                                  cfg.layer_norm_eps)
        inter = bias_gelu(matmul_maybe_int8(mlp_in, self.inter_w),
                          self.inter_b.to(mlp_in.dtype),
                          approximate=cfg.gelu_approximate)
        return bias_dropout_residual(
            matmul_maybe_int8(inter, self.output_w),
            self.output_b.to(inter.dtype), attn_out, rate, generator,
            deterministic)

    def sparse_attention(self, q, k, v, attn_mask=None):
        """Block-sparse attention of q, k, v [B, heads, S, d], routing the
        layer's additive mask as the JAX layer does: [B, 1, 1, S] becomes
        the key-padding mask, [1, 1, S, S] or [S, S] the attention mask
        (both in 'add' mode); any other shape raises."""
        s = q.shape[2]
        kp = am = None
        if attn_mask is not None:
            if attn_mask.dim() == 4 and tuple(attn_mask.shape[1:3]) == (1, 1):
                kp = attn_mask.reshape(attn_mask.shape[0], s)
            elif attn_mask.dim() == 4 and tuple(attn_mask.shape[:2]) == (1, 1):
                am = attn_mask.reshape(s, s)
            elif attn_mask.dim() == 2:
                am = attn_mask
            else:
                raise NotImplementedError(
                    "sparse attention supports [B,1,1,S] key-padding or 2D "
                    "[S,S] additive masks (the reference softmax's "
                    f"attn_mask is 2D-only); got shape {tuple(attn_mask.shape)}")
        return self.sparse_attn(q, k, v, causal=self.config.causal,
                                key_padding_mask=kp, attn_mask=am)

    def forward(self, x, attn_mask=None, generator=None,
                deterministic: bool = False):
        """x [B, S, H] -> [B, S, H].  attn_mask: an additive [B, 1, 1, S]
        or [B, 1, S, S] bias (takes the plain attention; a sparse layer
        takes the shapes `sparse_attention` routes).  Dropout draws from
        `generator` (on x's device): the attention seed (or the ctx mask),
        then the two hidden masks, three independent draws as the JAX
        layer's split of its rng.  Without a generator the layer is
        deterministic, and refuses to train with dropout configured."""
        cfg = self.config
        if generator is None:
            if not deterministic and (cfg.attn_dropout_ratio > 0.0
                                      or cfg.hidden_dropout_ratio > 0.0):
                raise ValueError(
                    "transformer layer called in training mode with dropout "
                    "configured but no generator — pass generator= or "
                    "deterministic=True")
            deterministic = True
        x = x.to(cfg.dtype)
        q, k, v = self.qkv_heads(x)
        if self.sparse_attn is not None:
            # output dropout, drawn where the dense path draws its seed
            ctx = dropout(self.sparse_attention(q, k, v, attn_mask),
                          cfg.attn_dropout_ratio, generator, deterministic)
            return self.attn_out_mlp(ctx, x, generator, deterministic)
        kernel_drop = cfg.attn_dropout_impl == "kernel"
        attn_rate = (0.0 if deterministic or not kernel_drop
                     else cfg.attn_dropout_ratio)
        seed = None
        if attn_rate > 0.0:
            seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                                 device=x.device, dtype=torch.int32)
        ctx = flash_attention(q, k, v, causal=cfg.causal, bias=attn_mask,
                              dropout_rate=attn_rate, dropout_seed=seed)
        if not kernel_drop:
            ctx = dropout(ctx, cfg.attn_dropout_ratio, generator,
                          deterministic)
        return self.attn_out_mlp(ctx, x, generator, deterministic)
