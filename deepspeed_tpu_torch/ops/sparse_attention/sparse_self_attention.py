"""Block-sparse self-attention over a SparsityConfig layout (counterpart of
deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py).

`SparseSelfAttention` follows the port's dispatch rule (ops/dispatch.py):
an unmasked call is `block_sparse_flash_attention`, which runs kernels F / G
on CUDA tensors and their plain twins on CPU tensors.  A call with rpe,
key_padding_mask or attn_mask runs `sparse_attention_reference`, the port of
the JAX gather path `_sparse_attention_impl`, in plain PyTorch on either
device (the JAX package leaves it to XLA too).  So does an unmasked call on
CUDA tensors whose layout block the kernels cannot tile (`sparse_tiling_ok`:
a multiple of 64; SparsityConfig's default block is 16), as the JAX module
sends a block its Pallas kernel cannot tile to the gather path; each such
call is counted on `SparseSelfAttention.gathered`.  The JAX module's `impl=`
switch ("pallas" | "gather" | "auto") chose between its TPU kernel and that
path; here the tensors' device and the block choose, so only "auto" is
taken.

The gather path pads every row to the layout's largest degree and holds an
fp32 [B, H, nb, block, max_deg * block] score tensor: O(S * max_deg *
block), which for layouts with global rows is dense-size.
"""

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..dispatch import use_kernel
from ..flash_attention import DEFAULT_MASK_VALUE
from .block_sparse_flash import (block_sparse_flash_attention, layout_gather,
                                 sparse_tiling_ok)
from .sparsity_config import SparsityConfig


def _gather_core(layout: np.ndarray, pad_last_valid: bool,
                 allow_empty_rows: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Shared gather-index builder: [H, nb, nb] bool ->
    (idx [H, nb, max_deg] int32, valid bool).  pad_last_valid repeats the
    row's last allowed block into the padding; otherwise padding is 0."""
    h, nb, _ = layout.shape
    degrees = layout.sum(-1)
    if not allow_empty_rows and (degrees == 0).any():
        raise ValueError("layout has a query block with no allowed k-blocks")
    max_deg = max(int(degrees.max()), 1)
    idx = np.zeros((h, nb, max_deg), np.int32)
    valid = np.zeros((h, nb, max_deg), bool)
    for hh in range(h):
        for i in range(nb):
            cols = np.nonzero(layout[hh, i])[0]
            idx[hh, i, :len(cols)] = cols
            valid[hh, i, :len(cols)] = True
            if pad_last_valid and len(cols):
                idx[hh, i, len(cols):] = cols[-1]
    return idx, valid


def layout_to_gather_indices(layout: np.ndarray
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """[H, nb, nb] bool -> (idx [H, nb, max_deg] int32, valid bool).

    idx[h, i, j] is the j-th allowed k-block of q-block i (padded with 0
    where valid is False)."""
    return _gather_core(layout, pad_last_valid=False, allow_empty_rows=False)


def gathered_mask_terms(kcols, nb, block, have, rpe, key_padding_mask,
                        attn_mask, kp_mode, attn_mode, batch):
    """Block-gathered additive mask terms, shared by
    sparse_attention_reference and the standalone Softmax op (matmul.py).
    kcols [H, nb, deg] (int64) holds each row-block's allowed k-block ids;
    every returned term broadcasts against the [B, H, nb, deg, bq, bk] score
    layout.  rpe is added; mul-mode masks turn zero entries into
    DEFAULT_MASK_VALUE, add-mode values pass through."""
    h = kcols.shape[0]
    heads = torch.arange(h, device=kcols.device)[:, None, None]
    rows = torch.arange(nb, device=kcols.device)[None, :, None]
    terms = []
    if "rpe" in have:
        r = rpe.float()
        if r.dim() == 2:
            r = r[None, None]
        elif r.dim() == 3:
            r = r[None]
        rb = r.reshape(r.shape[0], r.shape[1], nb, block, nb, block)
        rb = rb.movedim(4, 3)              # [b?, h?, nb_i, nb_j, bq, bk]
        rb = rb.expand(rb.shape[0], h, nb, nb, block, block)
        terms.append(rb[:, heads, rows, kcols])  # [B?, H, nb, deg, bq, bk]
    if "kp" in have:
        kpf = key_padding_mask.float()
        if kp_mode == "mul":
            kpf = torch.where(kpf == 0, DEFAULT_MASK_VALUE, 0.0)
        kp_g = kpf.reshape(batch, nb, block)[:, kcols]  # [B, H, nb, deg, bk]
        terms.append(kp_g[:, :, :, :, None, :])
    if "attn" in have:
        am = attn_mask.float()
        if attn_mode == "mul":
            am = torch.where(am == 0, DEFAULT_MASK_VALUE, 0.0)
        ab = am.reshape(nb, block, nb, block).movedim(2, 1)  # [nb_i, nb_j, bq, bk]
        terms.append(ab[rows, kcols][None])  # [1, H, nb, deg, bq, bk]
    return terms


def sparse_attention_reference(q, k, v, idx, valid, block: int,
                               causal: bool = False,
                               sm_scale: Optional[float] = None, rpe=None,
                               key_padding_mask=None, attn_mask=None,
                               kp_mode: str = "add", attn_mode: str = "add"):
    """The gather path (`_sparse_attention_impl`): q, k, v [B, H, S, D] and
    layout_to_gather_indices' idx / valid -> [B, H, S, D], in plain PyTorch
    (differentiated by autograd).  Scores in fp32 in the reference's order:
    x * scale + rpe + key_padding_mask + attn_mask, then the masked softmax
    over each row's allowed blocks; a fully masked row gives 0."""
    b, h, s, d = q.shape
    nb = s // block
    idx = idx.long()
    valid = valid.bool()
    max_deg = idx.shape[-1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)

    qb = q.reshape(b, h, nb, block, d)
    kb = k.reshape(b, h, nb, block, d)
    vb = v.reshape(b, h, nb, block, d)
    heads = torch.arange(h, device=q.device)[:, None, None]
    kg = kb[:, heads, idx]                    # [B, H, nb, max_deg, block, d]
    vg = vb[:, heads, idx]

    scores = torch.einsum("bhiqd,bhijkd->bhiqjk", qb.float(),
                          kg.float()) * scale
    have = tuple(name for name, t in (("rpe", rpe), ("kp", key_padding_mask),
                                      ("attn", attn_mask)) if t is not None)
    for term in gathered_mask_terms(idx, nb, block, have, rpe,
                                    key_padding_mask, attn_mask, kp_mode,
                                    attn_mode, b):
        scores = scores + term.movedim(-2, -3)  # -> [.., bq, deg, bk]
    if have:
        # two stacked mul-mode masks would overflow fp32 to -inf, and the
        # exp below would then give NaN on fully masked rows
        scores = scores.clamp_min(DEFAULT_MASK_VALUE)

    mask = valid[:, :, None, :, None]         # [H, nb, 1, max_deg, 1]
    if causal:
        ar = torch.arange(block, device=q.device)
        q_pos = torch.arange(nb, device=q.device)[:, None] * block + ar
        k_pos = idx[..., None] * block + ar                # [H, nb, deg, blk]
        causal_ok = (k_pos[:, :, None, :, :] <=
                     q_pos[None, :, :, None, None])      # [H,nb,blk,deg,blk]
        mask = mask & causal_ok
    scores = scores.masked_fill(~mask[None], DEFAULT_MASK_VALUE)

    flat = scores.reshape(b, h, nb, block, max_deg * block)
    m = flat.amax(dim=-1, keepdim=True)
    p = torch.exp(flat - m)
    # drop layout padding and mul-masked lanes: a fully masked row then
    # gives 0 instead of the reference kernel's NaN
    p = p * (flat > DEFAULT_MASK_VALUE / 2)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    p = (p / denom).reshape(b, h, nb, block, max_deg, block)
    out = torch.einsum("bhiqjk,bhijkd->bhiqd", p.to(v.dtype), vg)
    return out.reshape(b, h, s, d)


class SparseSelfAttention:
    """Layout-driven attention module (reference:
    sparse_self_attention.py:14).  The layout and its gather indices are
    built once per sequence length, and moved to a device once: a call
    copies nothing from the host.  `gathered` counts the unmasked calls on
    CUDA tensors that took the gather path because kernels F and G cannot
    tile the layout's block."""

    gathered = 0

    def __init__(self, sparsity_config: SparsityConfig,
                 key_padding_mask_mode: str = "add",
                 attn_mask_mode: str = "add", impl: str = "auto"):
        if impl != "auto":
            raise ValueError(
                f"impl={impl!r}: the port has no impl switch.  The rule of "
                "ops/dispatch.py chooses by device: CUDA tensors run kernels "
                "F / G, CPU tensors their plain twins, and masked calls the "
                "gather path on either device; pass impl='auto'")
        for mode in (key_padding_mask_mode, attn_mask_mode):
            if mode not in ("add", "mul"):
                raise ValueError(f"mask mode {mode!r} not in add|mul")
        self.sparsity_config = sparsity_config
        self.key_padding_mask_mode = key_padding_mask_mode
        self.attn_mask_mode = attn_mask_mode
        self._layouts = {}
        self._cache = {}

    def _host_layout(self, seq_len: int):
        if seq_len not in self._layouts:
            layout = self.sparsity_config.make_layout(seq_len)
            self._layouts[seq_len] = (
                layout, layout_to_gather_indices(layout),
                layout_gather(layout) + layout_gather(layout, transpose=True))
        return self._layouts[seq_len]

    def layout_for(self, seq_len: int, device="cpu"):
        """(layout [H, nb, nb] numpy, idx, valid, (fidx, fvalid, tidx,
        tvalid)): the gather path's indices and kernel F / G's forward and
        transposed ones, as tensors on `device`, built once."""
        device = torch.device(device)
        key = (seq_len, device)
        if key not in self._cache:
            layout, (idx, valid), flash = self._host_layout(seq_len)
            self._cache[key] = (
                layout, torch.as_tensor(idx, device=device),
                torch.as_tensor(valid, device=device),
                tuple(torch.as_tensor(a, device=device) for a in flash))
        return self._cache[key]

    def density(self, seq_len: int) -> float:
        return float(self._host_layout(seq_len)[0].mean())

    def __call__(self, q, k, v, causal: bool = False,
                 sm_scale: Optional[float] = None, rpe=None,
                 key_padding_mask=None, attn_mask=None):
        """q, k, v: [B, H, S, D] -> [B, H, S, D].

        rpe / key_padding_mask / attn_mask follow the reference forward
        (sparse_self_attention.py:105): rpe is [S, S] / [H, S, S] /
        [B, H, S, S] added to the scores; key_padding_mask is [B, S] over
        keys; attn_mask is [S, S]; each mask honors this module's add/mul
        mode.  Masked calls run the gather path, and so do unmasked calls
        on CUDA tensors at a block kernels F and G cannot tile (counted on
        `gathered`); other unmasked calls the block-sparse flash
        attention."""
        s = q.shape[2]
        block = self.sparsity_config.block
        if q.shape[1] != self.sparsity_config.num_heads:
            raise ValueError(
                f"q has {q.shape[1]} heads, layout built for "
                f"{self.sparsity_config.num_heads}")
        _, idx, valid, flash = self.layout_for(s, q.device)
        gather = rpe is not None or key_padding_mask is not None \
            or attn_mask is not None
        if not gather and not sparse_tiling_ok(block) \
                and use_kernel(q, k, v):
            SparseSelfAttention.gathered += 1
            gather = True
        if gather:
            return sparse_attention_reference(
                q, k, v, idx, valid, block, causal, sm_scale, rpe=rpe,
                key_padding_mask=key_padding_mask, attn_mask=attn_mask,
                kp_mode=self.key_padding_mask_mode,
                attn_mode=self.attn_mask_mode)
        fidx, fvalid, tidx, tvalid = flash
        return block_sparse_flash_attention(q, k, v, fidx, fvalid, tidx,
                                            tvalid, block, causal=causal,
                                            sm_scale=sm_scale)
