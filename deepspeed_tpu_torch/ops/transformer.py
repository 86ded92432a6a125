"""The transformer block (counterpart of deepspeed_tpu/ops/transformer.py).

`DeepSpeedTransformerLayer` is an `nn.Module` whose parameters carry the
reference's names and the JAX package's [in, out] layout (`x @ W`), so a
JAX checkpoint maps over by copying.  This slice ports the deterministic
pre-LN forward with a dense FFN and causal or bidirectional attention:
LN (kernel A) -> QKV matmul -> flash attention (kernel B) -> out-proj +
residual -> LN -> bias-gelu MLP + residual.  Matmul weights may be
replaced by int8 `QuantizedWeight`s, which route through kernel C.
"""

from dataclasses import dataclass

import torch
from torch import nn

from .activations import bias_gelu
from .flash_attention import flash_attention
from .normalize import fused_layer_norm
from .quant import matmul_maybe_int8


@dataclass
class DeepSpeedTransformerConfig:
    """Model-shape fields of deepspeed_tpu's DeepSpeedTransformerConfig
    (the TPU block sizes, attention impl and layout switches are not
    carried over, nor fp16: the kernels take bf16 and fp32)."""
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
        for name, shape in self.param_shapes(config).items():
            self.register_parameter(
                name, nn.Parameter(torch.zeros(shape), requires_grad=False))
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

    def attn_out_mlp(self, ctx, residual):
        """Out-projection of ctx [B, heads, S, d] + residual, then the pre-LN
        bias-gelu MLP + residual."""
        cfg = self.config
        b, heads, s, d = ctx.shape
        ctx = ctx.transpose(1, 2).reshape(b, s, heads * d)
        attn_out = matmul_maybe_int8(ctx, self.attn_ow) + \
            self.attn_ob.to(ctx.dtype)
        attn_out = attn_out + residual
        mlp_in = fused_layer_norm(attn_out, self.attn_nw, self.attn_nb,
                                  cfg.layer_norm_eps)
        inter = bias_gelu(matmul_maybe_int8(mlp_in, self.inter_w),
                          self.inter_b.to(mlp_in.dtype),
                          approximate=cfg.gelu_approximate)
        out = matmul_maybe_int8(inter, self.output_w) + \
            self.output_b.to(inter.dtype)
        return out + attn_out

    def forward(self, x, attn_mask=None):
        """x [B, S, H] -> [B, S, H], deterministic.  attn_mask: an additive
        [B, 1, 1, S] or [B, 1, S, S] bias (takes the plain attention)."""
        x = x.to(self.config.dtype)
        q, k, v = self.qkv_heads(x)
        ctx = flash_attention(q, k, v, causal=self.config.causal,
                              bias=attn_mask)
        return self.attn_out_mlp(ctx, x)
