"""InferenceEngine: prefill + KV-cache decode (counterpart of
deepspeed_tpu/inference/engine.py).

The engine takes the model over: it loads `model_parameters` into it when
given (else the module weights of a training checkpoint, `checkpoint=`: a
directory of either package's layout, runtime/checkpoint.py), moves it to
the device, optionally replaces each layer's four
matmul weights by int8 QuantizedWeights (`quantization_setting`), and
casts every other non-LayerNorm parameter to the compute dtype ONCE, so
that the model's per-call `.to(dtype)` casts (the JAX package's `astype`)
are no-ops; in particular the tied bf16 head matrix is made here, not on
every decode step.  LayerNorm parameters stay fp32, as in the JAX package.

`generate` runs one prefill over the prompt and then one eager decode
step per new token against static per-layer caches, each step a Python
loop over the layers (the JAX package compiles the whole loop; CUDA graphs
are the later counterpart).
"""

import torch

from ..models.convert import gpt2_params_from_jax, gpt2_params_to_jax
from ..models.gpt2 import GPT2Model
from ..ops.transformer_inference import (DeepSpeedTransformerInference,
                                         init_kv_cache)
from ..runtime.weight_quantizer import WeightQuantization
from ..utils.logging import log_dist


def _parse_quantization(setting):
    """quantization_setting: an int group count, or (mlp_extra_grouping,
    groups)."""
    if isinstance(setting, tuple):
        mlp_extra, groups = setting
        return bool(mlp_extra), int(groups)
    return False, int(setting)


def checkpoint_params(checkpoint, model: GPT2Model):
    """The model's state dict from the module weights of the checkpoint
    `latest` names under directory `checkpoint`."""
    from ..runtime.checkpoint import load_checkpoint_state
    cfg = model.config
    template = gpt2_params_to_jax(model.state_dict(), cfg)
    state, _, _ = load_checkpoint_state(checkpoint, None,
                                        {"module": template}, None)
    return gpt2_params_from_jax(state["module"], cfg)


class InferenceEngine:
    def __init__(self, model: GPT2Model, quantization_setting=None,
                 model_parameters=None, device=None, checkpoint=None):
        self.device = torch.device(device)
        self.module = model
        cfg = model.config
        self.dtype = cfg.dtype
        if model_parameters is None and checkpoint is not None:
            model_parameters = checkpoint_params(checkpoint, model)
        if model_parameters is not None:
            model.load_state_dict(model_parameters)
        model.to(self.device)

        self.quantization = None
        if quantization_setting:
            mlp_extra, groups = _parse_quantization(quantization_setting)
            wq = WeightQuantization(mlp_extra_grouping=mlp_extra,
                                    quantize_groups=groups)
            for layer in model.h:
                params = {name: getattr(layer, name)
                          for name in wq.LAYER_TARGETS}
                quantized = wq.quantize_layer_params(params, self.device)
                for name in wq.LAYER_TARGETS:
                    delattr(layer, name)  # drop the Parameter ...
                    setattr(layer, name, quantized[name])  # ... keep int8
            self.quantization = wq
            log_dist(f"int8-quantized layer weights (groups={groups})",
                     ranks=[0])

        for name, param in model.named_parameters():
            if not model.is_ln_param(name):
                param.data = param.data.to(self.dtype)

        self.inf_layer = DeepSpeedTransformerInference(cfg.layer_config())
        log_dist(f"InferenceEngine: {type(model).__name__} mp=1 "
                 f"dtype={self.dtype} device={self.device}"
                 f"{' int8' if self.quantization else ''}", ranks=[0])

    def _ids(self, input_ids):
        return torch.as_tensor(input_ids, device=self.device).long()

    @torch.no_grad()
    def forward(self, input_ids):
        """fp32 logits [B, S, V] of int ids [B, S]."""
        return self.module.logits(self._ids(input_ids))

    __call__ = forward

    @staticmethod
    def _sample(logits, temperature: float, generator):
        if temperature > 0:
            probs = torch.softmax(logits / max(temperature, 1e-6), dim=-1)
            return torch.multinomial(probs, 1, generator=generator)[:, 0]
        return torch.argmax(logits, dim=-1)

    def init_caches(self, batch: int, total: int):
        """One static KV cache per layer for `total` positions."""
        cfg = self.module.config
        heads = cfg.num_heads
        return [init_kv_cache(batch, heads, total, cfg.hidden_size // heads,
                              self.dtype, self.device)
                for _ in range(cfg.num_layers)]

    @torch.no_grad()
    def prefill(self, input_ids, caches):
        """Runs the prompt [B, S] through every layer, filling `caches`;
        returns the fp32 head logits [B, V] of its last position."""
        model = self.module
        h = model.embed(self._ids(input_ids), 0)
        for layer, cache in zip(model.h, caches):
            h = self.inf_layer.prefill(layer, h, cache)
        return model.head_logits(h[:, -1:, :])[:, -1]

    @torch.no_grad()
    def decode_step(self, tok, pos: int, caches):
        """One decode step of tokens [B] at position `pos` against
        `caches`; returns the fp32 head logits [B, V]."""
        model = self.module
        x = model.embed(tok[:, None], pos)
        for layer, cache in zip(model.h, caches):
            x = self.inf_layer.decode(layer, x, cache, pos)
        return model.head_logits(x)[:, -1]

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 16,
                 temperature: float = 0.0, generator=None):
        """Greedy (temperature=0) or sampled generation.  Returns the
        generated tokens [B, max_new_tokens] (prompt not included).
        Sampling draws from `generator` (on the engine's device; default: a
        fresh generator seeded 0)."""
        cfg = self.module.config
        ids = self._ids(input_ids)
        b, prompt_len = ids.shape
        total = prompt_len + int(max_new_tokens)
        if total > cfg.n_positions:
            raise ValueError(
                f"prompt ({prompt_len}) + max_new_tokens ({max_new_tokens}) "
                f"= {total} exceeds the model's n_positions "
                f"({cfg.n_positions})")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        caches = self.init_caches(b, total)
        tok = self._sample(self.prefill(ids, caches), temperature, generator)
        toks = [tok]
        for pos in range(prompt_len, total - 1):
            tok = self._sample(self.decode_step(tok, pos, caches),
                               temperature, generator)
            toks.append(tok)
        return torch.stack(toks, dim=1)
