"""Standalone block-sparse matmul (SDD / DSD / DDS) and block-sparse softmax
over a layout (counterpart of deepspeed_tpu/ops/sparse_attention/matmul.py).

Plain PyTorch on either device, as the JAX package leaves these to XLA:
every mode is a gather -> batched einsum (-> scatter for the softmax), and
autograd differentiates through it.

Sparse operand format (the reference's torch-blocksparse layout):
``[B, nnz, block, block]`` where ``nnz = layout.sum()`` and row ``n`` holds
the block at the n-th nonzero of ``layout [H, nb, nb]`` in row-major
(h, i, j) order; `block_coords` returns those coordinates.
"""

from typing import Tuple

import numpy as np
import torch


def block_coords(layout: np.ndarray) -> Tuple[np.ndarray, ...]:
    """(h, i, j) int32 coordinate arrays of layout's nonzeros, row-major:
    the order of the sparse format's nnz dimension."""
    layout = np.asarray(layout, bool)
    hs, is_, js = np.nonzero(layout)
    return hs.astype(np.int32), is_.astype(np.int32), js.astype(np.int32)


def _group_index(layout: np.ndarray, transpose: bool
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-(head, row-block) gather tables into the nnz dimension:
    (n_idx [H, nb, max_deg], other [H, nb, max_deg], valid).  For q-block i
    of head h, n_idx lists the positions in the nnz list of its allowed
    blocks and `other` the k-block ids (transpose=False); with
    transpose=True the grouping is by k-block j and `other` lists i."""
    layout = np.asarray(layout, bool)
    h, nb, _ = layout.shape
    nnz_of = -np.ones_like(layout, np.int32)
    nnz_of[np.nonzero(layout)] = np.arange(int(layout.sum()), dtype=np.int32)
    lay = layout.transpose(0, 2, 1) if transpose else layout
    deg = lay.sum(-1)
    max_deg = max(int(deg.max()), 1)
    n_idx = np.zeros((h, nb, max_deg), np.int32)
    other = np.zeros((h, nb, max_deg), np.int32)
    valid = np.zeros((h, nb, max_deg), bool)
    for hh in range(h):
        for i in range(nb):
            cols = np.nonzero(lay[hh, i])[0]
            other[hh, i, :len(cols)] = cols
            n_idx[hh, i, :len(cols)] = (nnz_of[hh, cols, i] if transpose
                                        else nnz_of[hh, i, cols])
            valid[hh, i, :len(cols)] = True
    return n_idx, other, valid


def _device_tables(tables, device):
    n_idx, other, valid = tables
    return (torch.as_tensor(n_idx, device=device).long(),
            torch.as_tensor(other, device=device).long(),
            torch.as_tensor(valid, device=device))


class MatMul:
    """`MatMul(layout, block, mode, trans_a, trans_b)`: API of the
    reference's Triton op (matmul.py:749).

    mode='sdd': c_sparse = a_dense @ b_dense at the layout's blocks (a, b
                [B, H, S, D]-style; the trans flags transpose the last two
                dims first, so sdd(q, k, trans_b=True) computes q @ k^T).
    mode='dsd': c_dense = a_sparse @ b_dense (trans_a transposes each
                stored block and the layout).
    mode='dds': c_dense = a_dense @ b_sparse.
    The index tables move to an operand's device once and stay there."""

    def __init__(self, layout, block: int, mode: str,
                 trans_a: bool = False, trans_b: bool = False):
        if mode not in ("sdd", "dsd", "dds"):
            raise ValueError(f"mode={mode!r} not in sdd|dsd|dds")
        self.layout = np.asarray(layout, bool)
        if self.layout.ndim != 3:
            raise ValueError("layout must be [H, nb, nb]")
        self.block = int(block)
        self.mode = mode
        self.trans_a = trans_a
        self.trans_b = trans_b
        self.nnz = int(self.layout.sum())
        self._coords = block_coords(self.layout)
        self._by_row = _group_index(self.layout, False)
        self._by_col = _group_index(self.layout, True)
        self._dev = {}

    def _tables(self, device):
        if device not in self._dev:
            self._dev[device] = (
                tuple(torch.as_tensor(c, device=device).long()
                      for c in self._coords),
                _device_tables(self._by_row, device),
                _device_tables(self._by_col, device))
        return self._dev[device]

    def _check_heads(self, x):
        """A head count other than the layout's (or 1, which broadcasts)
        would index the wrong head's blocks."""
        h = self.layout.shape[0]
        if x.shape[1] not in (1, h):
            raise ValueError(
                f"operand has {x.shape[1]} heads, layout built for {h} "
                "(1 broadcasts)")

    def _blocked(self, x, trans):
        """[B, H, S, D] (optionally transposing the trailing dims first) ->
        [B, H, nb, block, D]."""
        if trans:
            x = x.transpose(-1, -2)
        b, h, s, d = x.shape
        if s % self.block:
            raise ValueError(f"S={s} not a multiple of block={self.block}")
        return x.reshape(b, h, s // self.block, self.block, d)

    def _sdd(self, a, b):
        self._check_heads(a)
        self._check_heads(b)
        (hs, is_, js), _, _ = self._tables(a.device)
        heads = self.layout.shape[0]
        ab = self._blocked(a, self.trans_a)
        bb = self._blocked(b, not self.trans_b)  # contract over D
        ab = ab.expand(ab.shape[0], heads, *ab.shape[2:])
        bb = bb.expand(bb.shape[0], heads, *bb.shape[2:])
        a_g = ab[:, hs, is_]                     # [B, nnz, block, D]
        b_g = bb[:, hs, js]
        return torch.einsum("bnqd,bnkd->bnqk", a_g.float(),
                            b_g.float()).to(a.dtype)

    def _dsd(self, a_sparse, b):
        self._check_heads(b)
        _, by_row, by_col = self._tables(b.device)
        n_idx, other, valid = by_col if self.trans_a else by_row
        w = a_sparse.transpose(-1, -2) if self.trans_a else a_sparse
        bb = self._blocked(b, self.trans_b)
        h, nb, _ = n_idx.shape
        bb = bb.expand(bb.shape[0], h, *bb.shape[2:])
        w_g = w[:, n_idx].masked_fill(~valid[None, :, :, :, None, None], 0)
        b_g = bb[:, torch.arange(h, device=b.device)[:, None, None], other]
        out = torch.einsum("bhijqk,bhijkd->bhiqd", w_g.float(), b_g.float())
        bsz, d = b_g.shape[0], b_g.shape[-1]
        return out.reshape(bsz, h, nb * self.block, d).to(b.dtype)

    def _dds(self, a, b_sparse):
        self._check_heads(a)
        # c[.., m, j*block+k] = sum_i a[.., m, i*block+q] * w[n(h,i,j),q,k]
        _, by_row, by_col = self._tables(a.device)
        n_idx, other, valid = by_row if self.trans_b else by_col
        w = b_sparse.transpose(-1, -2) if self.trans_b else b_sparse
        a2 = a.transpose(-1, -2) if self.trans_a else a
        bsz, h_a, m, s = a2.shape
        h, nb, _ = n_idx.shape
        a_blk = a2.reshape(bsz, h_a, m, s // self.block, self.block)
        a_blk = a_blk.expand(bsz, h, m, *a_blk.shape[3:])
        a_g = a_blk[:, torch.arange(h, device=a.device)[:, None, None], :,
                    other]
        # numpy-style advanced indexing puts the indexed dims first:
        # [H, nb_j, deg, B, m, block_q]; move batch back
        a_g = a_g.movedim(3, 0)                  # [B, H, nb_j, deg, m, bq]
        w_g = w[:, n_idx].masked_fill(~valid[None, :, :, :, None, None], 0)
        out = torch.einsum("bhjimq,bhjiqk->bhjmk", a_g.float(), w_g.float())
        out = out.movedim(2, 3).reshape(bsz, h, m, nb * self.block)
        return out.to(a.dtype)

    def __call__(self, a, b):
        if self.mode == "sdd":
            return self._sdd(a, b)
        if self.mode == "dsd":
            return self._dsd(a, b)
        return self._dds(a, b)


class Softmax:
    """Block-sparse softmax with scale / rpe / key-padding / attention
    masks: API of the reference's softmax.py:315, in its order
    (x * scale + rpe + kp_mask + attn_mask, then a rowwise softmax over the
    row's allowed blocks).

    x: the sparse format [B, nnz, block, block].
    rpe: [S, S], [H, S, S] or [B, H, S, S], gathered at the layout's
         blocks and added.
    key_padding_mask: [B, S] over keys; mode 'add' adds the values, mode
         'mul' turns zero entries into DEFAULT_MASK_VALUE.
    attn_mask: [S, S]; the same two modes.
    Fully masked rows give 0 rather than the reference's NaN."""

    def __init__(self, layout, block: int):
        self.layout = np.asarray(layout, bool)
        self.block = int(block)
        self.nnz = int(self.layout.sum())
        self._by_row = _group_index(self.layout, False)
        self._dev = {}

    def __call__(self, x, scale=1.0, rpe=None, key_padding_mask=None,
                 attn_mask=None, key_padding_mask_mode="add",
                 attn_mask_mode="add"):
        from .sparse_self_attention import gathered_mask_terms
        if x.device not in self._dev:
            self._dev[x.device] = _device_tables(self._by_row, x.device)
        n_idx, other, valid = self._dev[x.device]
        have = tuple(name for name, t in
                     (("rpe", rpe), ("kp", key_padding_mask),
                      ("attn", attn_mask)) if t is not None)
        h, nb, max_deg = n_idx.shape
        blk = self.block
        bsz = x.shape[0]
        w = x[:, n_idx].float() * scale          # [B, H, nb, deg, bq, bk]
        for term in gathered_mask_terms(other, nb, blk, have, rpe,
                                        key_padding_mask, attn_mask,
                                        key_padding_mask_mode,
                                        attn_mask_mode, bsz):
            w = w + term
        neg = -1e30
        w = w.masked_fill(~valid[None, :, :, :, None, None], neg)
        w = w.clamp_min(neg)  # -inf + -inf stays finite for the max
        flat = w.movedim(-2, -3).reshape(bsz, h, nb, blk, max_deg * blk)
        m = flat.amax(-1, keepdim=True)
        p = torch.exp(flat - m) * (flat > neg / 2)  # drop masked lanes
        denom = p.sum(-1, keepdim=True).clamp_min(1e-30)
        p = (p / denom).reshape(bsz, h, nb, blk, max_deg, blk).movedim(-2, -3)
        # scatter back to the sparse format; padding entries route to a
        # dummy slot so they cannot clobber real blocks
        slot = torch.where(valid, n_idx, torch.full_like(n_idx, self.nnz))
        out = x.new_zeros((bsz, self.nnz + 1, blk, blk))
        out = out.index_put((torch.arange(bsz, device=x.device)
                             .view(-1, 1, 1, 1), slot[None]),
                            p.to(x.dtype))
        return out[:, :self.nnz]
