"""Kernels B, E, F and G pick their route by dtype: bf16 multiplies on the
tensor cores from 16-byte cp.async copies, fp32 on the CUDA cores.  The
choice (the dtype code the launch passes), the head dims the kernels are
compiled for, and the tensor-core route's alignment rule (a bf16 operand
whose base or strides are not multiples of 16 bytes is copied before the
launch, and the wrapper counts the copy) are plain Python, held here on
CPU tensors.  The wrappers run up to the launch against a stand-in for the
kernel library, which reads the operands back from the pointers and
strides it is handed and writes its plain twin's result through the output
pointers, as the kernel would (the kernels themselves run only on the
card, where chip_smoke.py holds them against their plain twins)."""

import ctypes
import importlib

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import op_builder, realign_counts
from deepspeed_tpu_torch.ops.dispatch import kernel_dtype_code
from deepspeed_tpu_torch.ops.flash_attention import (CP_ASYNC_BYTES,
                                                     KERNEL_HEAD_DIMS,
                                                     _heads_layout,
                                                     _launch_operands,
                                                     _misaligned,
                                                     _seq_strides)
from deepspeed_tpu_torch.ops.sparse_attention import block_sparse_flash as bsf
from deepspeed_tpu_torch.ops.sparse_attention import layout_gather

# the module (ops/__init__ exports a function under its name)
fa = importlib.import_module("deepspeed_tpu_torch.ops.flash_attention")


def _fused_views(b=2, s=8, h=3, d=64, dtype=torch.bfloat16, extra=0,
                 offset=0):
    """The layer's q, k, v: head views of one [B, S, 3 * H * D + extra]
    projection, as ops/transformer.py splits and transposes it; `offset`
    starts the views that many elements into the buffer."""
    qkv = torch.randn(b, s, 3 * h * d + extra + offset,
                      generator=torch.Generator().manual_seed(d + extra))
    qkv = qkv.to(dtype)[..., offset:]
    return [t.view(b, s, h, d).transpose(1, 2)
            for t in qkv[..., :3 * h * d].split(h * d, dim=-1)]


class _Counter:
    """A stand-in wrapper that only carries `realigned`."""
    realigned = 0


def _route_strides(name, dtype, **operands):
    """What a kernel B, E, F or G wrapper does with its operands before the
    launch: the dtype code picks the route, and on the tensor-core route
    an operand that breaks the 16-byte rule is copied.  Returns the
    tensors the launch reads, their strides, and the copies made."""
    counter = _Counter()
    tensors, strides = _launch_operands(
        name, counter, kernel_dtype_code(torch.empty(0, dtype=dtype)),
        operands, {})
    return tensors, [tuple(strides[i:i + 3])
                     for i in range(0, len(strides), 3)], counter.realigned


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "tensor_cores"),
                                         (torch.float32, "cuda_cores")])
def test_kernel_route_by_dtype(dtype, route):
    """bf16 passes DTYPE_BF16, which the kernels dispatch to tc:: (and the
    wrappers hold to the cp.async rule); fp32 passes DTYPE_FP32 (fp32::)."""
    code = kernel_dtype_code(torch.empty(0, dtype=dtype))
    expected = {"tensor_cores": op_builder.DTYPE_BF16,
                "cuda_cores": op_builder.DTYPE_FP32}[route]
    assert code == expected
    assert op_builder.DTYPE_BF16 != op_builder.DTYPE_FP32


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_kernel_route_refuses_other_dtypes(dtype):
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        kernel_dtype_code(torch.empty(0, dtype=dtype))


@pytest.mark.parametrize("d", [64, 128, 32, 96])
def test_the_layers_layouts_pass_the_alignment_check(d):
    """Contiguous [B, H, S, D], the fused-QKV head views and the wrappers'
    own [B, S, H, D] outputs all meet the rule at every compiled head dim:
    nothing is copied."""
    q, k, v = _fused_views(d=d)
    out = _heads_layout(2, 3, 8, d, q)
    dense = torch.zeros(2, 3, 8, d, dtype=torch.bfloat16)
    tensors, strides, copies = _route_strides("t", torch.bfloat16, q=q, k=k,
                                              v=v, out=out, dense=dense)
    assert copies == 0
    assert all(a is b for a, b in zip(tensors, (q, k, v, out, dense)))
    assert strides[0] == (8 * 3 * 3 * d, d, 3 * 3 * d)
    assert strides[3] == (8 * 3 * d, d, 3 * d)
    assert strides[4] == (3 * 8 * d, 8 * d, d)


def _assert_copied(tensors, originals, which):
    """Operand `which` (an index) is a fresh aligned contiguous copy of the
    original, equal to it; every other operand is passed unchanged."""
    for i, (t, o) in enumerate(zip(tensors, originals)):
        if i == which:
            assert t is not o and t.data_ptr() != o.data_ptr()
            assert t.is_contiguous() and not _misaligned(t)
            assert torch.equal(t, o)
        else:
            assert t is o


def test_misaligned_base_pointer_names_the_operand():
    """A head view that starts one element into the projection is 2 bytes
    off a 16-byte boundary: that operand, `k`, and no other is copied."""
    q, _, _ = _fused_views()
    k = _fused_views(offset=1)[1]
    assert k.data_ptr() % CP_ASYNC_BYTES == 2 and _misaligned(k)
    tensors, strides, copies = _route_strides(
        "flash_attention_cuda", torch.bfloat16, q=q, k=k, v=q)
    assert copies == 1
    _assert_copied(tensors, (q, k, q), 1)
    assert strides[1] == (3 * 8 * 64, 8 * 64, 64)


def test_odd_sequence_stride_names_the_operand():
    """A projection of 3 * H * D + 1 columns gives a sequence stride of
    577 elements (1154 bytes): `v` is copied."""
    q, k, _ = _fused_views()
    v = _fused_views(extra=1)[2]
    assert v.stride(2) == 3 * 3 * 64 + 1
    tensors, _, copies = _route_strides("flash_attention_bwd_dq_cuda",
                                        torch.bfloat16, q=q, k=k, v=v)
    assert copies == 1
    _assert_copied(tensors, (q, k, v), 2)


@pytest.mark.parametrize("dim,what", [(0, "batch"), (1, "head")])
def test_odd_batch_or_head_stride_names_the_operand(dim, what):
    """An odd batch or head stride: `dout` is copied, `q` is not."""
    base = torch.arange(4 * 4 * 8 * 64 + 64, dtype=torch.float32).to(
        torch.bfloat16)
    strides = [4 * 8 * 64, 8 * 64, 64, 1]
    strides[dim] += 1
    t = base.as_strided((2, 2, 8, 64), strides)
    q = base[:64].view(1, 1, 1, 64)
    tensors, _, copies = _route_strides("t", torch.bfloat16, q=q, dout=t)
    assert copies == 1, what
    _assert_copied(tensors, (q, t), 1)


def test_strides_of_length_one_dims_are_ignored():
    """A batch or head of one is never stepped over: its stride does not
    matter (PyTorch may leave any value there), and nothing is copied."""
    t = torch.zeros(1, 1, 8, 64, dtype=torch.bfloat16).as_strided(
        (1, 1, 8, 64), (3, 5, 64, 1))
    tensors, strides, copies = _route_strides("t", torch.bfloat16, q=t)
    assert strides == [(3, 5, 64)] and copies == 0 and tensors[0] is t


def test_fp32_takes_the_cuda_core_route_without_the_alignment_rule():
    """The CUDA-core route reads element by element: a misaligned fp32
    view is launched as it is, the same layout in bf16 is copied."""
    q = _fused_views(dtype=torch.float32, offset=1)[0]
    assert q.data_ptr() % CP_ASYNC_BYTES == 4
    tensors, _, copies = _route_strides("t", torch.float32, q=q, k=q, v=q)
    assert copies == 0 and all(t is q for t in tensors)
    q16 = _fused_views(offset=1)[0]
    tensors, _, copies = _route_strides("t", torch.bfloat16, q=q16, k=q16,
                                        v=q16)
    assert copies == 3 and not any(_misaligned(t) for t in tensors)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_a_strided_head_dim_names_the_operand_on_either_route(dtype):
    """Both routes read rows of D contiguous elements: that still raises,
    it is not copied."""
    q, _, _ = _fused_views(dtype=dtype)
    lse_like = torch.zeros(2, 3, 64, 8, dtype=dtype).transpose(2, 3)
    with pytest.raises(ValueError, match=r"`dout`: the head dim must be "
                                         r"dense"):
        _route_strides("t", dtype, q=q, dout=lse_like)
    with pytest.raises(ValueError, match="head dim must be dense"):
        _seq_strides("t", "dout", lse_like)


# ---------------------------------------------------------------------- #
# the wrappers up to the launch, against a stand-in kernel library
# ---------------------------------------------------------------------- #
H, S, BLOCK = 2, 128, 64


def _at(ptr, shape, strides, dtype):
    """The tensor of `shape` and element `strides` at CPU address ptr,
    sharing its memory (what a kernel reads and writes there)."""
    extent = 1 + sum((n - 1) * st for n, st in zip(shape, strides))
    size = torch.empty((), dtype=dtype).element_size()
    raw = (ctypes.c_char * (extent * size)).from_address(ptr)
    return torch.frombuffer(raw, dtype=dtype).as_strided(shape, strides)


def _grads_from_stats(q, k, v, do, lse, delta, scale, allowed):
    """dq, dk, dv from the forward's lse and delta = rowsum(dO * O), in
    fp32, scores outside `allowed` [.., S, S] giving P = 0 (kernels E and
    G's math)."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    p = torch.where(allowed, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None]) * scale
    return (torch.einsum("bhqk,bhkd->bhqd", ds, kf),
            torch.einsum("bhqk,bhqd->bhkd", ds, qf),
            torch.einsum("bhqk,bhqd->bhkd", p, dof))


def _causal(sq, sk):
    return torch.ones(sq, sk, dtype=torch.bool).tril()


def _layout_mask(idx, valid, block, transpose=False):
    """The [H, S, S] mask of the layout that gather indices describe."""
    heads, nb, _ = idx.shape
    layout = torch.zeros(heads, nb, nb, dtype=torch.bool)
    for h_ in range(heads):
        for i in range(nb):
            for j, ok in zip(idx[h_, i].tolist(), valid[h_, i].tolist()):
                if ok:
                    layout[(h_, j, i) if transpose else (h_, i, j)] = True
    return layout.repeat_interleave(block, 1).repeat_interleave(block, 2)


class _Kernels:
    """Stand-in for the kernel library: each launcher reads its operands
    back from the pointers and strides the wrapper hands it, computes the
    plain twin's result, writes it through the output pointers, and
    records the call (the pointers it read and the dtype code)."""

    def __init__(self):
        self.calls = []

    def _record(self, name, code, **ptrs):
        self.calls.append({"fn": name, "code": code, **ptrs})

    @staticmethod
    def _dtype(code):
        return torch.bfloat16 if code == op_builder.DTYPE_BF16 \
            else torch.float32

    def _operands(self, ptrs, shape, strides, dtype):
        return [_at(p, shape, tuple(strides[3 * i:3 * i + 3]) + (1,), dtype)
                for i, p in enumerate(ptrs)]

    def ds_flash_attention_fwd(self, q, k, v, o, lse, b, h, sq, sk, d, chunks,
                               *rest):
        strides, (scale, causal, _seed, _thr, _ks, code, _stream) = \
            rest[:12], rest[12:]
        dt = self._dtype(code)
        qt, kt, vt, ot = self._operands((q, k, v, o), (b, h, sq, d),
                                        strides, dt)
        out, ref_lse = fa.mha_reference(qt, kt, vt, causal=bool(causal),
                                        sm_scale=scale, return_lse=True)
        ot.copy_(out)
        _at(lse, (b, h, sq), (h * sq, sq, 1), torch.float32).copy_(ref_lse)
        self._record("fwd", code, q=q, k=k, v=v, d=d, chunks=chunks,
                     scale=scale)
        return 0

    def _bwd(self, fn, ptrs, b, h, sq, d, chunks, strides, scale, causal,
             code, outs, allowed=None):
        dt = self._dtype(code)
        q, k, v, do = self._operands(ptrs[:4], (b, h, sq, d), strides, dt)
        lse, delta = (_at(p, (b, h, sq), (h * sq, sq, 1), torch.float32)
                      for p in ptrs[4:6])
        if allowed is None:
            allowed = _causal(sq, sq) if causal else torch.ones(
                sq, sq, dtype=torch.bool)
        elif causal:
            allowed = allowed & _causal(sq, sq)
        grads = dict(zip(("dq", "dk", "dv"), _grads_from_stats(
            q, k, v, do, lse, delta, scale, allowed)))
        out_views = self._operands(ptrs[6:6 + len(outs)], (b, h, sq, d),
                                   strides[12:], dt)
        for name, view in zip(outs, out_views):
            view.copy_(grads[name])
        self._record(fn, code, q=ptrs[0], k=ptrs[1], v=ptrs[2], dout=ptrs[3],
                     d=d, chunks=chunks, scale=scale)
        return 0

    def ds_flash_attention_bwd_dkdv(self, q, k, v, do, lse, delta, dk, dv, b,
                                    h, sq, sk, d, chunks, strides, scale,
                                    causal, _seed, _thr, _ks, code, _stream):
        return self._bwd("dkdv", (q, k, v, do, lse, delta, dk, dv), b, h, sq,
                         d, chunks, strides, scale, causal, code,
                         ("dk", "dv"))

    def ds_flash_attention_bwd_dq(self, q, k, v, do, lse, delta, dq, b, h, sq,
                                  sk, d, chunks, strides, scale, causal,
                                  _seed, _thr, _ks, code, _stream):
        return self._bwd("dq", (q, k, v, do, lse, delta, dq), b, h, sq, d,
                         chunks, strides, scale, causal, code, ("dq",))

    @staticmethod
    def _indices(idx, valid, h, nb, max_deg):
        return (_at(p, (h, nb, max_deg), (nb * max_deg, max_deg, 1),
                    torch.int32) for p in (idx, valid))

    def ds_block_sparse_flash_fwd(self, q, k, v, o, lse, idx, valid, b, h, s,
                                  d, chunks, block, max_deg, strides, scale,
                                  causal, code, _stream):
        dt = self._dtype(code)
        qt, kt, vt, ot = self._operands((q, k, v, o), (b, h, s, d), strides,
                                        dt)
        it, vl = self._indices(idx, valid, h, s // block, max_deg)
        out, ref_lse = bsf.block_sparse_flash_fwd_reference(
            qt, kt, vt, it, vl, block, bool(causal), scale)
        ot.copy_(out)
        _at(lse, (b, h, s), (h * s, s, 1), torch.float32).copy_(ref_lse)
        self._record("bsf_fwd", code, q=q, k=k, v=v, d=d, chunks=chunks,
                     scale=scale)
        return 0

    def ds_block_sparse_flash_bwd_dq(self, q, k, v, do, lse, delta, dq, idx,
                                     valid, b, h, s, d, chunks, block,
                                     max_deg, strides, scale, causal, code,
                                     _stream):
        it, vl = self._indices(idx, valid, h, s // block, max_deg)
        return self._bwd("bsf_dq", (q, k, v, do, lse, delta, dq), b, h, s, d,
                         chunks, strides, scale, causal, code, ("dq",),
                         _layout_mask(it, vl, block))

    def ds_block_sparse_flash_bwd_dkdv(self, q, k, v, do, lse, delta, dk, dv,
                                       idx_t, valid_t, b, h, s, d, chunks,
                                       block, max_deg, strides, scale, causal,
                                       code, _stream):
        it, vl = self._indices(idx_t, valid_t, h, s // block, max_deg)
        return self._bwd("bsf_dkdv", (q, k, v, do, lse, delta, dk, dv), b, h,
                         s, d, chunks, strides, scale, causal, code,
                         ("dk", "dv"),
                         _layout_mask(it, vl, block, transpose=True))


@pytest.fixture
def kernels(monkeypatch):
    """The wrappers of kernels B, E, F and G with CPU tensors taken as if
    they lay on the card: the device check passes, and the launches go to
    a _Kernels stand-in."""
    lib = _Kernels()
    monkeypatch.setattr(op_builder, "load", lambda: lib)
    monkeypatch.setattr(fa, "check_cuda", lambda name, *t: 0)
    monkeypatch.setattr(fa, "stream_handle", lambda index: 0)
    monkeypatch.setattr(bsf, "stream_handle", lambda index: 0)
    yield lib


def _layout():
    """Kernel-sized Fixed layout: 2 heads, 2 blocks of 64, causal-friendly."""
    layout = np.zeros((H, S // BLOCK, S // BLOCK), bool)
    layout[:, 0, 0] = layout[:, 1, :] = True
    layout[1, 1, 0] = False
    return layout


def _attention_inputs(d, dtype, offset=0):
    """q, k, v as fused-QKV views (k shifted `offset` elements into its own
    buffer when offset > 0), dout, and the forward's out / lse from the
    plain twin; every tensor on the CPU."""
    q, _, v = _fused_views(b=2, s=S, h=H, d=d, dtype=dtype)
    k = _fused_views(b=2, s=S, h=H, d=d, dtype=dtype, offset=offset)[1]
    do = torch.randn(2, H, S, d, generator=torch.Generator().manual_seed(3))
    return q, k, v, do.to(dtype)


def _call(kind, q, k, v, do, causal=True, stats=None):
    """One wrapper's launch on the inputs; returns its outputs.  `stats`
    gives the backward's (lse, delta) instead of the plain forward's."""
    fidx, fvalid = (torch.from_numpy(a) for a in layout_gather(_layout()))
    tidx, tvalid = (torch.from_numpy(a)
                    for a in layout_gather(_layout(), transpose=True))
    if stats is not None:
        lse, delta = stats
    else:
        if kind in ("fwd", "dkdv", "dq"):
            out, lse = fa.mha_reference(q, k, v, causal=causal,
                                        return_lse=True)
        else:
            out, lse = bsf.block_sparse_flash_fwd_reference(
                q, k, v, fidx, fvalid, BLOCK, causal)
        delta = (do.float() * out.float()).sum(-1)
        lse = lse.float().contiguous()
    return {
        "fwd": lambda: fa.flash_attention_cuda(q, k, v, causal=causal),
        "dkdv": lambda: fa.flash_attention_bwd_dkdv_cuda(
            q, k, v, do, lse, delta, causal=causal),
        "dq": lambda: (fa.flash_attention_bwd_dq_cuda(
            q, k, v, do, lse, delta, causal=causal),),
        "bsf_fwd": lambda: bsf.block_sparse_flash_fwd_cuda(
            q, k, v, fidx, fvalid, BLOCK, causal),
        "bsf_dq": lambda: (bsf.block_sparse_flash_bwd_dq_cuda(
            q, k, v, do, lse, delta, fidx, fvalid, BLOCK, causal),),
        "bsf_dkdv": lambda: bsf.block_sparse_flash_bwd_dkdv_cuda(
            q, k, v, do, lse, delta, tidx, tvalid, BLOCK, causal),
    }[kind]()


def _plain(kind, q, k, v, do, causal=True):
    """The plain twins' result of the same launch."""
    fidx, fvalid = (torch.from_numpy(a) for a in layout_gather(_layout()))
    if kind in ("fwd", "dkdv", "dq"):
        out, lse = fa.mha_reference(q, k, v, causal=causal, return_lse=True)
        if kind == "fwd":
            return out, lse
        dq, dk, dv = fa.flash_attention_bwd_reference(
            q, k, v, out, lse, do, causal=causal)
    else:
        out, lse = bsf.block_sparse_flash_fwd_reference(
            q, k, v, fidx, fvalid, BLOCK, causal)
        if kind == "bsf_fwd":
            return out, lse
        dq, dk, dv = bsf.block_sparse_flash_bwd_reference(
            q, k, v, out, lse, do, fidx, fvalid, BLOCK, causal)
    return (dq,) if kind.endswith("dq") else (dk, dv)


KINDS = ["fwd", "dkdv", "dq", "bsf_fwd", "bsf_dq", "bsf_dkdv"]
WRAPPERS = {"fwd": fa.flash_attention_cuda,
            "dkdv": fa.flash_attention_bwd_dkdv_cuda,
            "dq": fa.flash_attention_bwd_dq_cuda,
            "bsf_fwd": bsf.block_sparse_flash_fwd_cuda,
            "bsf_dq": bsf.block_sparse_flash_bwd_dq_cuda,
            "bsf_dkdv": bsf.block_sparse_flash_bwd_dkdv_cuda}


def _close(got, ref, dtype):
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.float().numpy(), r.float().numpy(),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("d", KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("kind", KINDS)
def test_wrappers_launch_every_compiled_head_dim(kernels, kind, d):
    """B, E, F and G launch at D = 32, 64, 96 and 128, and the launch
    computes the plain twin's result from what the wrapper hands it (fp32,
    atol = rtol = 1e-5)."""
    q, k, v, do = _attention_inputs(d, torch.float32)
    got = _call(kind, q, k, v, do)
    assert len(kernels.calls) == 1
    _close(got, _plain(kind, q, k, v, do), torch.float32)


@pytest.mark.parametrize("kind", KINDS)
def test_wrappers_refuse_other_head_dims(kind, kernels):
    """Every head dim >= 1 runs: D = 264, 320 and 300 reach the launch in
    either dtype with the plan the wrapper chose (the wide kernels, bf16 on
    the tensor cores at D rounded up to a multiple of 8, fp32 on the CUDA
    cores at D itself, ceil(width / 128) column chunks; only bf16 D = 300
    is copied, zero-padded to 304), and the launch computes the plain
    twin's result at the true D; D <= 0 still raises ValueError naming the
    rule, before the device check."""
    for d in (264, 320, 300):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = _attention_inputs(d, dtype)
            WRAPPERS[kind].realigned = 0
            got = _call(kind, q, k, v, do)
            call = kernels.calls[-1]
            bf16 = dtype == torch.bfloat16
            width = -(-d // 8) * 8 if bf16 else d
            route = fa.ROUTE_TENSOR_CORES_WIDE if bf16 \
                else fa.ROUTE_CUDA_CORES_WIDE
            assert fa.head_dim_plan(call["code"], d) == (route, width,
                                                         -(-width // 128))
            assert (call["d"], call["chunks"]) == (width, -(-width // 128))
            assert call["code"] == kernel_dtype_code(q)
            operands = 3 if kind.endswith("fwd") else 4
            assert WRAPPERS[kind].realigned == (
                operands if width != d else 0)
            assert all(g.shape[-1] == d
                       for g in (got[:1] if "fwd" in kind else got))
            _close(got, _plain(kind, q, k, v, do), dtype)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = _attention_inputs(4, dtype)
        q, k, v, do = (t[..., :0] for t in (q, k, v, do))
        stats = torch.zeros(2, 2, H, S)
        with pytest.raises(ValueError, match=r"head dim 0 not supported "
                                             r"\(the kernels take any head "
                                             r"dim >= 1\)"):
            _call(kind, q, k, v, do, stats=stats)
    assert len(kernels.calls) == 6


@pytest.mark.parametrize("d,compiled,padded", [
    (8, 32, 8), (24, 32, 24), (32, 32, 32), (40, 64, 40), (80, 96, 80),
    (96, 96, 96), (104, 128, 104), (128, 128, 128), (1, 32, 8),
    (36, 64, 40), (100, 128, 104), (136, 256, 136), (200, 256, 200),
    (256, 256, 256)])
def test_a_head_dim_runs_the_smallest_instantiation_at_or_above_it(
        d, compiled, padded):
    """Any head dim from 1 to 256 maps to the smallest compiled head dim at
    or above it (the C launchers take the same one).  The tensor-core route
    launches it rounded up to a multiple of 8 (`padded`); the CUDA-core
    route launches it as it is."""
    assert fa.kernel_head_dim(d) == compiled
    assert fa.launch_head_dim(op_builder.DTYPE_BF16, d) == padded
    assert fa.launch_head_dim(op_builder.DTYPE_FP32, d) == d
    assert fa.kernel_head_dim(padded) == compiled


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [36, 136])
@pytest.mark.parametrize("kind", KINDS)
def test_wrappers_launch_other_head_dims(kernels, kind, d, dtype):
    """D = 36 (not a multiple of 8) and D = 136 (above 128) reach the launch
    on either route, and the launch computes the plain twin's result from
    what the wrapper hands it; the outputs have the true head dim."""
    q, k, v, do = _attention_inputs(d, dtype)
    got = _call(kind, q, k, v, do)
    assert len(kernels.calls) == 1
    assert all(t.shape[-1] == d for t in (got[:1] if "fwd" in kind else got))
    _close(got, _plain(kind, q, k, v, do), dtype)


@pytest.mark.parametrize("kind", KINDS)
def test_a_head_dim_off_the_copy_width_is_zero_padded_once(kernels, kind,
                                                           monkeypatch):
    """bf16 at D = 36: the wrapper copies each operand the launch reads
    once into a zero-padded contiguous buffer 40 wide, counts each copy on
    `realigned`, launches D = 40 with the scale of the true D (1 / 6), and
    hands back outputs [..., 36] equal to the plain twin's; fp32 launches
    D = 36 itself and copies nothing."""
    copies = []
    pad = fa._zero_padded
    monkeypatch.setattr(fa, "_zero_padded",
                        lambda t, width: copies.append(pad(t, width))
                        or copies[-1])
    q, k, v, do = _attention_inputs(36, torch.bfloat16)
    for w in WRAPPERS.values():
        w.realigned = 0
    got = _call(kind, q, k, v, do)
    call = kernels.calls[-1]
    operands = ("q", "k", "v") if kind.endswith("fwd") else ("q", "k", "v",
                                                             "dout")
    assert WRAPPERS[kind].realigned == len(operands) == len(copies)
    assert call["d"] == 40 and call["scale"] == pytest.approx(1 / 6)
    for arg, t, padded in zip(operands, (q, k, v, do), copies):
        assert call[arg] == padded.data_ptr() and padded.is_contiguous()
        assert padded.shape == t.shape[:3] + (40,)
        assert torch.equal(padded[..., :36], t)
        assert not padded[..., 36:].any()
    assert all(g.shape[-1] == 36 for g in (got[:1] if "fwd" in kind else got))
    _close(got, _plain(kind, q, k, v, do), torch.bfloat16)
    q, k, v, do = _attention_inputs(36, torch.float32)
    WRAPPERS[kind].realigned = 0
    _call(kind, q, k, v, do)
    assert kernels.calls[-1]["d"] == 36 and WRAPPERS[kind].realigned == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", KINDS)
def test_wrappers_launch_at_head_dim_80_with_the_true_d(kernels, kind, dtype):
    """D = 80 reaches the launch with D = 80 itself (the kernel zero-fills
    the columns up to its instantiation, 96), and the launch computes the
    plain twin's result from what the wrapper hands it."""
    q, k, v, do = _attention_inputs(80, dtype)
    got = _call(kind, q, k, v, do)
    assert len(kernels.calls) == 1 and got[0].shape[-1] == 80
    _close(got, _plain(kind, q, k, v, do), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", ["bsf_fwd", "bsf_dq", "bsf_dkdv"])
def test_sparse_kernels_take_the_route_by_dtype(kernels, kind, dtype):
    """F and G pass the dtype code the kernels dispatch on (tc:: for bf16,
    fp32:: for fp32), as B and E do, and hold bf16 to the alignment rule:
    the fused-QKV views pass as they are."""
    q, k, v, do = _attention_inputs(64, dtype)
    WRAPPERS[kind].realigned = 0
    _call(kind, q, k, v, do)
    call = kernels.calls[-1]
    assert call["code"] == kernel_dtype_code(q)
    assert (call["q"], call["k"], call["v"]) == tuple(
        t.data_ptr() for t in (q, k, v))
    assert WRAPPERS[kind].realigned == 0


@pytest.mark.parametrize("kind", KINDS)
def test_a_misaligned_operand_is_copied_and_the_result_is_the_aligned_calls(
        kernels, kind):
    """A bf16 `k` two bytes off a 16-byte boundary: the wrapper hands the
    launch a fresh aligned copy of it (and the other operands unchanged),
    counts one realigned operand, and the result equals that of the same
    call on an aligned `k` of the same values, bitwise."""
    q, k, v, do = _attention_inputs(64, torch.bfloat16, offset=1)
    assert k.data_ptr() % CP_ASYNC_BYTES == 2
    for w in WRAPPERS.values():
        w.realigned = 0
    got = _call(kind, q, k, v, do)
    call = kernels.calls[-1]
    assert call["k"] != k.data_ptr() and call["k"] % CP_ASYNC_BYTES == 0
    assert (call["q"], call["v"]) == (q.data_ptr(), v.data_ptr())
    assert WRAPPERS[kind].realigned == 1
    assert sum(realign_counts().values()) == 1
    aligned = _call(kind, q, k.clone(memory_format=torch.contiguous_format),
                    v, do)
    assert WRAPPERS[kind].realigned == 1
    for g, r in zip(got, aligned):
        assert torch.equal(g, r)
    _close(got, _plain(kind, q, k, v, do), torch.bfloat16)


def test_realign_counts_name_the_attention_kernels():
    """realign_counts() covers the six launches of B, E, F and G (and the
    six tensor-core product launches of kernels H, I and J, and kernel C's
    prefill route), and reset_launch_counts() zeroes them."""
    from deepspeed_tpu_torch.ops import reset_launch_counts
    fa.flash_attention_cuda.realigned = 3
    assert set(realign_counts()) == {
        "flash_attention_fwd", "flash_attention_bwd_dkdv",
        "flash_attention_bwd_dq", "block_sparse_flash_fwd",
        "block_sparse_flash_bwd_dq", "block_sparse_flash_bwd_dkdv",
        "fcm_tile_ag", "fcm_tile_ag_t", "fcm_tile_rs", "fcm_ag_step",
        "fcm_ag_step_t", "fcm_rs_producer", "dequant_matmul"}
    reset_launch_counts()
    assert set(realign_counts().values()) == {0}
