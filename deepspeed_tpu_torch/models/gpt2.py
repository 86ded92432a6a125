"""GPT-2 (counterpart of deepspeed_tpu/models/gpt2.py): the serving forward
and the training loss.

The parameters mirror the JAX tree: `wte` [V, H], `wpe` [P, H], the layers
under `h.<i>.` (unrolled in a Python loop where the JAX package scans a
stacked [L, ...] tree), `ln_f.w`/`ln_f.b`, and `lm_head` [H, V] when the
embeddings are untied.  They are fp32 and trainable; compute runs in
config.dtype.  `loss` (also `forward`, as the JAX model's `__call__`) is
the next-token cross-entropy, through the chunked
`fused_linear_cross_entropy` by default.  With `activation_checkpointing`
each layer is recomputed in the backward, as the JAX model's
`jax.checkpoint(body)`: only the layer's input is saved, and the
recompute draws its dropout masks again from the layer's generator state
(runtime/activation_checkpointing `checkpoint_with_generator`), so the loss
and the gradients equal those without recompute, bit for bit.  At ZeRO
stage 3 the engine installs its layer stream
(`install_zero3_streaming`) and calls `loss` once with every local rank's
batch as lists: each rank's embedding and head run on its gathered copy
of the non-layer leaves, and the layers run through the stream in group
lockstep over the ranks (runtime/zero/stage3_streaming.py).  PLD is not
ported yet.
"""

import functools
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn
from torch.func import functional_call

from ..ops.activations import dropout
from ..ops.fused_cross_entropy import fused_linear_cross_entropy
from ..ops.normalize import fused_layer_norm
from ..ops.transformer import (DeepSpeedTransformerConfig,
                               DeepSpeedTransformerLayer)
from ..runtime.activation_checkpointing.checkpointing import (
    checkpoint_with_generator, nothing_saveable)


@dataclass
class GPT2Config:
    vocab_size: int = 50304          # 50257 padded to a 128 multiple
    n_positions: int = 1024
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: Optional[int] = None
    embd_dropout: float = 0.1
    attn_dropout: float = 0.1
    hidden_dropout: float = 0.1
    layer_norm_eps: float = 1e-5
    initializer_range: float = 0.02
    bf16: bool = True
    # "kernel" (probability dropout inside the flash kernel, the
    # reference's semantics) | "ctx" (dropout on the attention output)
    attn_dropout_impl: str = "kernel"
    activation_checkpointing: bool = False
    # a SparsityConfig: every layer's attention is block-sparse (kernels
    # F / G, with dropout on the attention output); flops_per_token stays
    # the dense count
    sparse_attention: Optional[object] = None
    tie_word_embeddings: bool = True
    # chunked LM head + cross-entropy that never holds the [B, S, V] fp32
    # logits (ops/fused_cross_entropy.py); None = the auto chunk
    fused_loss: bool = True
    fused_loss_chunk: Optional[int] = None

    def __post_init__(self):
        if self.intermediate_size is None:
            self.intermediate_size = 4 * self.hidden_size

    @property
    def dtype(self):
        return torch.bfloat16 if self.bf16 else torch.float32

    def layer_config(self) -> DeepSpeedTransformerConfig:
        return DeepSpeedTransformerConfig(
            hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            heads=self.num_heads,
            attn_dropout_ratio=self.attn_dropout,
            hidden_dropout_ratio=self.hidden_dropout,
            num_hidden_layers=self.num_layers,
            initializer_range=self.initializer_range,
            layer_norm_eps=self.layer_norm_eps,
            bf16=self.bf16,
            pre_layer_norm=True,
            causal=True,
            attn_dropout_impl=self.attn_dropout_impl,
            sparsity_config=self.sparse_attention,
        )

    def num_params(self, include_embeddings: bool = True) -> int:
        h, i = self.hidden_size, self.intermediate_size
        layer = 4 * h * h + 2 * h * i + 9 * h + i
        n = self.num_layers * layer + 2 * h
        if include_embeddings:
            n += (self.vocab_size + self.n_positions) * h
        return n

    def flops_per_token(self) -> int:
        """Training FLOPs per token (forward + backward ~ 6N + attention +
        LM head), the Megatron-style count the JAX package's MFU uses: the
        vocabulary projection is a real [*, H] x [H, V] product and counts
        (the embedding lookup does not)."""
        n = self.num_params(include_embeddings=False)
        attn = 12 * self.num_layers * self.hidden_size * self.n_positions
        head = 6 * self.hidden_size * self.vocab_size
        return 6 * n + attn + head


def _run_layer(layer, names, deterministic, h, *tensors, generator=None):
    """layer(h) on `tensors` as its parameters `names`."""
    return functional_call(layer, dict(zip(names, tensors)), (h,),
                           {"generator": generator,
                            "deterministic": deterministic})


class _FinalNorm(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.w = nn.Parameter(torch.ones(hidden))
        self.b = nn.Parameter(torch.zeros(hidden))


class GPT2Model(nn.Module):
    """Decoder-only LM over DeepSpeedTransformerLayers.  Parameters are
    fp32 and trainable at creation (embeddings and matmul weights zero until
    init_params or load_state_dict); compute runs in config.dtype."""

    # parameters that stay fp32 when the inference engine casts the rest
    LN_PARAMS = ("ln_f.w", "ln_f.b")

    def __init__(self, config: GPT2Config):
        super().__init__()
        self.config = config
        h = config.hidden_size
        self.wte = nn.Parameter(torch.zeros(config.vocab_size, h))
        self.wpe = nn.Parameter(torch.zeros(config.n_positions, h))
        layer_cfg = config.layer_config()
        self.h = nn.ModuleList(DeepSpeedTransformerLayer(layer_cfg)
                               for _ in range(config.num_layers))
        self.ln_f = _FinalNorm(h)
        if not config.tie_word_embeddings:
            self.lm_head = nn.Parameter(torch.zeros(h, config.vocab_size))
        self._zero3_stream = None

    def install_zero3_streaming(self, stream) -> None:
        """Engine hook at ZeRO stage 3: the rank-list forms of `loss` and
        `hidden_states` run the layer stack through `stream`
        (runtime/zero/stage3_streaming.Zero3StreamContext)."""
        self._zero3_stream = stream

    @staticmethod
    def param_partition_spec(name: str):
        """The JAX model's tensor-parallel spec of parameter `name`
        (vocab-sharded embeddings, the layers' Megatron splits), which
        ZeRO-3 cuts around (runtime/zero/partition.py)."""
        from ..parallel.mesh import MODEL_AXIS
        from ..runtime.zero.partition import PartitionSpec as P
        parts = name.split(".")
        if parts[0] == "h":
            return DeepSpeedTransformerLayer.param_partition_specs()[parts[2]]
        return {"wte": P(MODEL_AXIS, None),
                "lm_head": P(None, MODEL_AXIS)}.get(name, P())

    @staticmethod
    def layer_index(name: str) -> Optional[int]:
        """The layer a parameter belongs to (None outside the layers)."""
        parts = name.split(".")
        return int(parts[1]) if parts[0] == "h" else None

    @staticmethod
    def jax_leaf(name: str) -> str:
        """The leaf of the JAX parameter tree that holds parameter `name`:
        the JAX model stacks each layer parameter over the layers, so the
        `h.<i>.<leaf>` of every layer i lie in one leaf, `h.<leaf>`."""
        parts = name.split(".")
        return ".".join(parts[:1] + parts[2:]) if parts[0] == "h" else name

    def is_ln_param(self, name: str) -> bool:
        return name in self.LN_PARAMS or \
            name.rsplit(".", 1)[-1] in DeepSpeedTransformerLayer.LN_PARAMS

    @torch.no_grad()
    def init_params(self, generator: torch.Generator):
        """Embeddings and matmul weights ~ N(0, initializer_range) drawn
        from `generator` (on the parameters' device), biases 0, LN 1/0."""
        std = self.config.initializer_range
        self.wte.normal_(0.0, std, generator=generator)
        self.wpe.normal_(0.0, std, generator=generator)
        for layer in self.h:
            layer.init_params(generator)
        self.ln_f.w.fill_(1.0)
        self.ln_f.b.zero_()
        if not self.config.tie_word_embeddings:
            self.lm_head.normal_(0.0, std, generator=generator)
        return self

    # -- forward -------------------------------------------------------- #
    def embed(self, input_ids, position_offset: int = 0):
        """Token + position embedding of int ids [B, S]; position_offset
        places a decode token at its position in the sequence."""
        dtype = self.config.dtype
        ids = input_ids.long()
        pos = torch.arange(position_offset, position_offset + ids.shape[1],
                           device=ids.device)
        return self.wte.to(dtype)[ids] + self.wpe.to(dtype)[pos]

    def _head_matrix(self, dtype):
        """[H, V] LM projection: tied wte.T or the untied lm_head."""
        if self.config.tie_word_embeddings:
            return self.wte.to(dtype).T
        return self.lm_head.to(dtype)

    def _final_hidden(self, h):
        """Final layer norm shared by head_logits and the fused loss."""
        return fused_layer_norm(h, self.ln_f.w, self.ln_f.b,
                                self.config.layer_norm_eps)

    @staticmethod
    def _shift_for_next_token(h, input_ids, labels):
        """Next-token convention: when labels is None, input_ids[:, 1:] are
        the targets and the last hidden column is dropped (the attention
        length stays unchanged)."""
        if labels is None:
            return h[:, :-1], input_ids[:, 1:]
        return h, labels

    def head_logits(self, h):
        """Final LN + LM head, fp32 logits."""
        h = self._final_hidden(h)
        return (h @ self._head_matrix(h.dtype)).float()

    def embed_dropout(self, input_ids, generator=None,
                      deterministic: bool = False):
        """The embedding and its dropout: the hidden states the layers
        take."""
        return dropout(self.embed(input_ids), self.config.embd_dropout,
                       generator, deterministic)

    def hidden_states(self, input_ids, generator=None,
                      deterministic: bool = False):
        """input_ids [B, S] -> pre-head hidden states [B, S, H].  Dropout
        (embedding, then each layer's) draws from `generator`, on the
        model's device; without one the pass is deterministic, as the JAX
        model without an rng.  With activation_checkpointing (and grad
        enabled) each layer is checkpointed, recomputing everything but its
        input.  At ZeRO stage 3 `input_ids` and `generator` are lists, one
        entry a local rank, and so is the result: the layers run through
        the installed stream, which recomputes each layer itself under
        activation_checkpointing (stage3_streaming `_RematLayer`)."""
        if isinstance(input_ids, (list, tuple)):
            stream = self._zero3_stream
            if stream is None or not stream.usable():
                raise RuntimeError(
                    "the rank-list forward runs inside a stage-3 engine's "
                    "forward (runtime/zero/stage3_streaming.py)")
            gens = (list(generator) if generator is not None
                    else [None] * len(input_ids))
            deterministic = deterministic or gens[0] is None
            hs = [stream.call(i, self.embed_dropout, ids, gen, deterministic)
                  for i, (ids, gen) in enumerate(zip(input_ids, gens))]
            return stream.scan(self.h, hs, gens, deterministic,
                               remat=self.config.activation_checkpointing)
        if generator is None:
            deterministic = True
        h = self.embed_dropout(input_ids, generator, deterministic)
        remat = self.config.activation_checkpointing and \
            torch.is_grad_enabled()
        for layer in self.h:
            if remat:
                # the layer's tensors of this call go in as inputs: under
                # the engine's functional_call they are the compute-dtype
                # casts, which the recompute (in the backward, after the
                # call has put the masters back) must read again
                params = dict(layer.named_parameters())
                h = checkpoint_with_generator(
                    functools.partial(_run_layer, layer, tuple(params),
                                      deterministic),
                    generator, h, *params.values(), policy=nothing_saveable)
            else:
                h = layer(h, generator=generator, deterministic=deterministic)
        return h

    def logits(self, input_ids):
        """fp32 logits [B, S, V], deterministic (the serving forward)."""
        return self.head_logits(self.hidden_states(input_ids))

    def loss(self, input_ids, labels=None, generator=None):
        """Next-token cross-entropy (fp32 softmax), training mode when a
        generator is given.  When labels is None, input_ids[:, 1:] are the
        targets.  With config.fused_loss (default) the head projection and
        the cross-entropy run chunked over the vocabulary and never hold
        the [B, S, V] fp32 logits.  At ZeRO stage 3 the arguments are
        lists, one entry a local rank, and so is the result (one loss a
        rank)."""
        if isinstance(input_ids, (list, tuple)):
            ids = [i.long() for i in input_ids]
            hs = self.hidden_states(ids, generator,
                                    deterministic=generator is None)
            labels = labels if labels is not None else [None] * len(ids)
            return [self._zero3_stream.call(i, self.head_loss, h, x, lab)
                    for i, (h, x, lab) in enumerate(zip(hs, ids, labels))]
        ids = input_ids.long()
        h = self.hidden_states(ids, generator, deterministic=generator is None)
        return self.head_loss(h, ids, labels)

    def head_loss(self, h, ids, labels=None):
        """The loss of the last layer's hidden states `h` (the part of
        `loss` after the layers)."""
        cfg = self.config
        if cfg.fused_loss:
            h, targets = self._shift_for_next_token(self._final_hidden(h), ids,
                                                    labels)
            return fused_linear_cross_entropy(
                h.reshape(-1, cfg.hidden_size), self._head_matrix(h.dtype),
                targets.reshape(-1), cfg.fused_loss_chunk)
        logits, targets = self._shift_for_next_token(self.head_logits(h), ids,
                                                     labels)
        return torch.nn.functional.cross_entropy(
            logits.reshape(-1, cfg.vocab_size), targets.reshape(-1).long())

    # the JAX model's __call__ is its loss: the engine's entry point
    forward = loss

    # -- layer streaming (ZeRO-Infinity parameter offload) -------------- #
    def layerwise_api(self):
        """The model cut into streaming groups for ZeroInfinityEngine
        (runtime/zero/infinity.py), as the JAX model's layerwise_api:
        "embed" {wte, wpe}, "layer<i>" {the layer's leaves}, "head"
        {"ln_f": {w, b}} (and lm_head when untied), each a tree of the JAX
        split's keys.  `split` / `join` / `join_consuming` map the port's
        state-dict names to and from the groups; `embed_fn(embed_g, ids,
        seed)`, `layer_fn(layer_g, h, seed, layer_idx)` and
        `head_loss_fn(head_g, embed_g, h, ids, labels)` compute on a
        group's tensors (any dtype: they cast to the model's).  A seed (None
        for no dropout) takes the place of the JAX rng: layer_fn draws its
        masks from a generator seeded by (seed, layer_idx), the counterpart
        of fold_in(rng, layer_idx), so a recompute from the layer's input
        draws kernel B's dropout mask and the hidden masks again, bit for
        bit.  The head reads the tied wte from the embed group."""
        cfg = self.config
        n = cfg.num_layers
        layer_names = list(DeepSpeedTransformerLayer.param_shapes(
            cfg.layer_config()))

        def split(params):
            groups = {"embed": {"wte": params["wte"], "wpe": params["wpe"]}}
            for i in range(n):
                groups[f"layer{i}"] = {k: params[f"h.{i}.{k}"]
                                       for k in layer_names}
            head = {"ln_f": {"w": params["ln_f.w"], "b": params["ln_f.b"]}}
            if not cfg.tie_word_embeddings:
                head["lm_head"] = params["lm_head"]
            groups["head"] = head
            return groups

        def join_consuming(groups):
            """join, dropping each group from `groups` as it is read."""
            out = {"wte": groups["embed"]["wte"],
                   "wpe": groups["embed"]["wpe"]}
            groups["embed"] = None
            for i in range(n):
                layer = groups[f"layer{i}"]
                groups[f"layer{i}"] = None
                out.update({f"h.{i}.{k}": layer[k] for k in layer_names})
            head = groups["head"]
            groups["head"] = None
            out["ln_f.w"], out["ln_f.b"] = head["ln_f"]["w"], head["ln_f"]["b"]
            if not cfg.tie_word_embeddings:
                out["lm_head"] = head["lm_head"]
            return {name: out[name] for name, _ in self.named_parameters()}

        def join(groups):
            return join_consuming(dict(groups))

        def generator_for(seed, device, index):
            gen = torch.Generator(device=device)
            gen.manual_seed((int(seed) * 1_000_003 + index + 1) % 2 ** 63)
            return gen

        def embed_fn(embed_g, input_ids, seed):
            ids = input_ids.long()
            pos = torch.arange(ids.shape[1], device=ids.device)
            h = embed_g["wte"].to(cfg.dtype)[ids] + \
                embed_g["wpe"].to(cfg.dtype)[pos]
            if seed is None:
                return h
            return dropout(h, cfg.embd_dropout,
                           generator_for(seed, h.device, -1))

        def layer_fn(layer_g, h, seed, layer_idx):
            cast = {k: v.to(cfg.dtype) for k, v in layer_g.items()}
            gen = (None if seed is None
                   else generator_for(seed, h.device, int(layer_idx)))
            return functional_call(self.h[layer_idx], cast, (h,),
                                   {"generator": gen,
                                    "deterministic": seed is None})

        def head_loss_fn(head_g, embed_g, h, input_ids, labels=None):
            hs = fused_layer_norm(h, head_g["ln_f"]["w"].to(cfg.dtype),
                                  head_g["ln_f"]["b"].to(cfg.dtype),
                                  cfg.layer_norm_eps)
            head = (embed_g["wte"].to(hs.dtype).T if cfg.tie_word_embeddings
                    else head_g["lm_head"].to(hs.dtype))
            hs, targets = self._shift_for_next_token(hs, input_ids.long(),
                                                     labels)
            if cfg.fused_loss:
                return fused_linear_cross_entropy(
                    hs.reshape(-1, cfg.hidden_size), head,
                    targets.reshape(-1), cfg.fused_loss_chunk)
            logits = (hs @ head).float()
            return torch.nn.functional.cross_entropy(
                logits.reshape(-1, cfg.vocab_size),
                targets.reshape(-1).long())

        return {"split": split, "join": join,
                "join_consuming": join_consuming, "embed_fn": embed_fn,
                "layer_fn": layer_fn, "head_loss_fn": head_loss_fn,
                "num_layers": n}
