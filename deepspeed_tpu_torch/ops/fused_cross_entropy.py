"""Fused (chunked) linear + softmax cross-entropy (counterpart of
deepspeed_tpu/ops/fused_cross_entropy.py).

Never holds more than one vocabulary CHUNK of logits: the forward streams
the logsumexp over chunks (online softmax) and the backward recomputes
each chunk to emit dh and dW incrementally, O(N * chunk) live instead of
O(N * V).  A vocabulary that the chunk does not divide is padded up to
whole chunks; padded columns are masked to -inf so they add nothing to the
loss or the gradients.  Plain PyTorch (`torch.matmul` for the products), as
no Pallas kernel stands behind it in the JAX package.  The products take
their operands in h's dtype (the tensor cores' bf16 in training); the
softmax, the loss and the dh sum across chunks are fp32.
"""

import torch

# Auto chunk policy of the JAX package: bound the transient [N, chunk] fp32
# logits block (512M elements, 2 GB).
_CE_CHUNK_ELEM_BUDGET = 1 << 29


def _plan(vocab: int, chunk_size, n_tokens: int):
    """(chunk, n_chunks, padded_vocab) with chunk * n_chunks == padded."""
    if chunk_size is None:
        chunk_size = max(4096, _CE_CHUNK_ELEM_BUDGET // max(1, n_tokens))
    c = max(1, min(chunk_size, vocab))
    n_chunks = -(-vocab // c)
    return c, n_chunks, c * n_chunks


def _valid_mask(labels, ignore_index):
    if ignore_index is None:
        return (torch.ones(labels.shape, dtype=torch.float32,
                           device=labels.device),
                torch.tensor(float(labels.shape[0]), device=labels.device))
    valid = (labels != ignore_index).float()
    return valid, torch.clamp(valid.sum(), min=1.0)


def _chunk_logits(h, w, idx, c, vocab):
    """fp32 logits of vocabulary chunk idx [N, c], padding at -inf."""
    w_i = w[:, idx * c:(idx + 1) * c].to(h.dtype)
    logits = torch.matmul(h, w_i).float()
    if logits.shape[1] < c:  # the last chunk of a padded vocabulary
        logits = torch.nn.functional.pad(logits, (0, c - logits.shape[1]),
                                         value=-float("inf"))
    return logits


class _FusedLinearCrossEntropy(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h, w, labels, chunk_size, ignore_index):
        n = h.shape[0]
        vocab = w.shape[1]
        c, n_chunks, _ = _plan(vocab, chunk_size, n)
        labels = labels.long()
        valid, denom = _valid_mask(labels, ignore_index)
        m = torch.full((n,), -float("inf"), device=h.device)
        s = torch.zeros(n, device=h.device)
        label_logit = torch.zeros(n, device=h.device)
        for idx in range(n_chunks):
            logits = _chunk_logits(h, w, idx, c, vocab)
            m_new = torch.maximum(m, logits.max(dim=1).values)
            s = s * torch.exp(m - m_new) + torch.exp(
                logits - m_new[:, None]).sum(dim=1)
            m = m_new
            local = labels - idx * c
            in_chunk = (local >= 0) & (local < c)
            lab = torch.gather(logits, 1, local.clamp(0, c - 1)[:, None])[:, 0]
            label_logit = label_logit + torch.where(in_chunk, lab,
                                                    torch.zeros_like(lab))
        lse = m + torch.log(s)
        loss = ((lse - label_logit) * valid).sum() / denom
        ctx.save_for_backward(h, w, labels, lse)
        ctx.plan = (chunk_size, ignore_index)
        return loss

    @staticmethod
    def backward(ctx, g):
        h, w, labels, lse = ctx.saved_tensors
        chunk_size, ignore_index = ctx.plan
        n, hid = h.shape
        vocab = w.shape[1]
        c, n_chunks, _ = _plan(vocab, chunk_size, n)
        valid, denom = _valid_mask(labels, ignore_index)
        scale = (g / denom) * valid  # d mean / d token, 0 where ignored
        # dh accumulates in fp32 across chunks, as the JAX package does
        dh = torch.zeros((n, hid), dtype=torch.float32, device=h.device)
        dw = torch.empty((hid, vocab), dtype=torch.float32, device=h.device)
        cols = torch.arange(c, device=h.device)
        for idx in range(n_chunks):
            logits = _chunk_logits(h, w, idx, c, vocab)
            p = torch.exp(logits - lse[:, None])  # 0 on padding
            onehot = (labels - idx * c)[:, None] == cols[None, :]
            grad_logits = (p - onehot.float()) * scale[:, None]
            width = min(c, vocab - idx * c)
            gl = grad_logits[:, :width].to(h.dtype)
            w_i = w[:, idx * c:idx * c + width].to(h.dtype)
            dh += torch.matmul(gl, w_i.T).float()
            dw[:, idx * c:idx * c + width] = torch.matmul(h.T, gl).float()
        return dh.to(h.dtype), dw.to(w.dtype), None, None, None


def fused_linear_cross_entropy(h, w, labels, chunk_size=None,
                               ignore_index=None):
    """Mean over (valid) tokens of CE(softmax(h @ w), labels).

    h: [N, H] hidden states (any float dtype; products accumulate in fp32);
    w: [H, V] head projection; labels: [N] int.  ignore_index: labels equal
    to it add nothing to the loss or the gradients and leave the mean."""
    return _FusedLinearCrossEntropy.apply(h, w, labels, chunk_size,
                                          ignore_index)
