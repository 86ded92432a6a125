"""The port's sparse-attention package against the JAX package on the CPU:
layouts and gather indices bitwise, the plain twins of kernels F and G
against the Pallas kernels in interpret mode, SparseSelfAttention against
the JAX module's gather path (masks and rpe included), the standalone
MatMul / Softmax ops, BertSparseSelfAttention, the helpers, the sparse
transformer layer, and the refusals.  Inputs come from numpy seeds; small
sizes (H=2, block=16, S=128, D=8, as tests/unit/test_sparse_attention.py).
Tolerances are the JAX file's own: fp32 2e-5 for outputs, 5e-4 for
grads."""

from dataclasses import dataclass

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu.ops.sparse_attention.block_sparse_flash import (
    block_sparse_flash_bwd as jax_bsf_bwd)
from deepspeed_tpu.ops.sparse_attention.block_sparse_flash import (
    block_sparse_flash_fwd as jax_bsf_fwd)
from deepspeed_tpu.ops.transformer import (
    DeepSpeedTransformerConfig as JaxLayerConfig)
from deepspeed_tpu.ops.transformer import (
    DeepSpeedTransformerLayer as JaxLayer)
from deepspeed_tpu_torch.ops import launch_counts, reset_launch_counts
from deepspeed_tpu_torch.ops import sparse_attention as tsa
from deepspeed_tpu_torch.ops.flash_attention import DEFAULT_MASK_VALUE
from deepspeed_tpu_torch.ops.sparse_attention.block_sparse_flash import (
    block_sparse_flash_attention, block_sparse_flash_bwd_dkdv_cuda,
    block_sparse_flash_bwd_dq_cuda, block_sparse_flash_bwd_reference,
    block_sparse_flash_fwd_cuda, block_sparse_flash_fwd_reference)
from deepspeed_tpu_torch.ops.transformer import (DeepSpeedTransformerConfig,
                                                 DeepSpeedTransformerLayer)

H, BLOCK, S, D = 2, 16, 128, 8
OUT_TOL, GRAD_TOL = 2e-5, 5e-4

# (class name, kwargs) built identically from both packages
CONFIGS = [
    ("DenseSparsityConfig", {}),
    ("FixedSparsityConfig", dict(num_local_blocks=4, num_global_blocks=1)),
    ("FixedSparsityConfig", dict(num_local_blocks=4, num_global_blocks=1,
                                 attention="unidirectional")),
    ("VariableSparsityConfig", dict(num_random_blocks=1,
                                    local_window_blocks=[2, 4],
                                    global_block_indices=[0],
                                    different_layout_per_head=True)),
    ("BigBirdSparsityConfig", dict(num_random_blocks=1,
                                   num_sliding_window_blocks=3,
                                   num_global_blocks=1,
                                   different_layout_per_head=True, seed=3)),
    ("BSLongformerSparsityConfig", dict(num_sliding_window_blocks=3,
                                        global_block_indices=[0])),
]
CONFIG_IDS = [f"{name}-{i}" for i, (name, _) in enumerate(CONFIGS)]
# the layouts the JAX file runs its Pallas kernel on
FLASH = [CONFIGS[1], CONFIGS[4], CONFIGS[5]]
FLASH_IDS = [CONFIG_IDS[1], CONFIG_IDS[4], CONFIG_IDS[5]]


def _pair(spec, heads=H, block=BLOCK):
    name, kw = spec
    return (getattr(jsa, name)(num_heads=heads, block=block, **kw),
            getattr(tsa, name)(num_heads=heads, block=block, **kw))


def _arrays(n, shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _t(*arrays, grad=False):
    return [torch.from_numpy(a.copy()).requires_grad_(grad) for a in arrays]


def _close(out, ref, tol):
    np.testing.assert_allclose(np.asarray(out, np.float32),
                               np.asarray(ref, np.float32), rtol=tol, atol=tol)


# ---------------------------------------------------------------------- #
# layouts and gather indices
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("seq", [S, 2 * S])
@pytest.mark.parametrize("spec", CONFIGS, ids=CONFIG_IDS)
def test_layouts_bitwise_equal_jax(spec, seq):
    jcfg, tcfg = _pair(spec)
    ref, out = jcfg.make_layout(seq), tcfg.make_layout(seq)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("spec", CONFIGS, ids=CONFIG_IDS)
def test_gather_indices_equal_jax(spec):
    """layout_gather in both directions and layout_to_gather_indices."""
    jcfg, _ = _pair(spec)
    layout = jcfg.make_layout(S)
    for transpose in (False, True):
        for ours, ref in zip(tsa.layout_gather(layout, transpose),
                             jsa.layout_gather(layout, transpose)):
            assert ours.dtype == ref.dtype
            np.testing.assert_array_equal(ours, ref)
    for ours, ref in zip(tsa.layout_to_gather_indices(layout),
                         jsa.layout_to_gather_indices(layout)):
        np.testing.assert_array_equal(ours, ref)


def test_bench_bigbird_layout():
    """bench_sparse_longseq's layout at S=8192: bitwise the JAX package's,
    density 0.4414, and 65 live blocks per head under the causal mask
    (49 below the diagonal, 16 on it), the same for every head."""
    kw = dict(num_heads=12, block=512, num_random_blocks=1,
              num_sliding_window_blocks=3, num_global_blocks=1)
    ours = tsa.BigBirdSparsityConfig(**kw).make_layout(8192)
    np.testing.assert_array_equal(
        ours, jsa.BigBirdSparsityConfig(**kw).make_layout(8192))
    assert round(float(ours.mean()), 4) == 0.4414
    causal = np.tril(ours)
    assert (causal.sum((1, 2)) == 65).all()
    assert (np.diagonal(causal, axis1=1, axis2=2).sum(-1) == 16).all()
    assert (ours == ours[:1]).all()


# ---------------------------------------------------------------------- #
# the plain twins of kernels F and G vs the Pallas kernels (interpret)
# ---------------------------------------------------------------------- #
def _twin_vs_pallas(layout, block, seq, causal, seed, d=D):
    heads = layout.shape[0]
    q, k, v, do = _arrays(4, (2, heads, seq, d), seed)
    fidx, fvalid = jsa.layout_gather(layout)
    tidx, tvalid = jsa.layout_gather(layout, transpose=True)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    ref_out, ref_lse = jax_bsf_fwd(jq, jk, jv, jnp.asarray(fidx),
                                   jnp.asarray(fvalid), block, causal,
                                   interpret=True, return_lse=True)
    ref_grads = jax_bsf_bwd(jq, jk, jv, ref_out, ref_lse, jnp.asarray(do),
                            *map(jnp.asarray, (fidx, fvalid, tidx, tvalid)),
                            block, causal, interpret=True)
    tq, tk, tv, tdo = _t(q, k, v, do)
    ti, tvl = _t(fidx, fvalid)
    out, lse = block_sparse_flash_fwd_reference(tq, tk, tv, ti, tvl, block,
                                                causal)
    grads = block_sparse_flash_bwd_reference(tq, tk, tv, out, lse, tdo, ti,
                                             tvl, block, causal)
    return (out, lse, grads), (ref_out, ref_lse, ref_grads)


# the three layouts causal and not at D = 8, and BigBird at the kernels'
# head dims 32, 96 and 256 (64 and 128 have the sizes of every other D
# here), at D = 80, which the kernels run zero-filled in their D = 96
# instantiation, and at D = 36, which the tensor-core route pads to 40
TWIN_CASES = (
    [pytest.param(spec, causal, D, id=f"{sid}-{causal}")
     for spec, sid in zip(FLASH, FLASH_IDS) for causal in (False, True)]
    + [pytest.param(FLASH[1], causal, d, id=f"{FLASH_IDS[1]}-{causal}-d{d}")
       for d in (32, 96, 80, 36, 256, 264, 320) for causal in (False, True)])


@pytest.mark.parametrize("spec,causal,d", TWIN_CASES)
def test_twins_match_pallas_kernels(spec, causal, d):
    """Out and lse against block_sparse_flash_fwd(interpret=True,
    return_lse=True), dq / dk / dv against block_sparse_flash_bwd(
    interpret=True), on the same forward out and lse."""
    jcfg, _ = _pair(spec)
    (out, lse, grads), (rout, rlse, rgrads) = _twin_vs_pallas(
        jcfg.make_layout(S), BLOCK, S, causal, seed=11, d=d)
    _close(out, rout, OUT_TOL)
    _close(lse, rlse, OUT_TOL)
    for g, r in zip(grads, rgrads):
        _close(g, r, GRAD_TOL)


def test_empty_causal_row():
    """A q-block whose allowed blocks all lie above the diagonal: out 0 and
    an lse at the mask value in both, zero dq there, and the backward
    never takes exp(s - lse) of those rows (grads finite, equal to the
    Pallas kernels')."""
    layout = np.zeros((H, 4, 4), bool)
    layout[:, 0, 0] = True
    layout[:, 1, [2, 3]] = True
    layout[:, 2, [0, 2]] = True
    layout[:, 3, :] = True
    (out, lse, grads), (rout, rlse, rgrads) = _twin_vs_pallas(
        layout, BLOCK, 4 * BLOCK, True, seed=12)
    rows = slice(BLOCK, 2 * BLOCK)
    assert (out[:, :, rows] == 0).all()
    assert (lse[:, :, rows] < DEFAULT_MASK_VALUE / 2).all()
    assert (np.asarray(rlse)[:, :, rows] < DEFAULT_MASK_VALUE / 2).all()
    live = np.ones(4 * BLOCK, bool)
    live[rows] = False
    _close(out, rout, OUT_TOL)
    _close(lse[:, :, live], np.asarray(rlse)[:, :, live], OUT_TOL)
    for g, r in zip(grads, rgrads):
        assert torch.isfinite(g).all()
        _close(g, r, GRAD_TOL)
    assert (grads[0][:, :, rows] == 0).all()
    # and through autograd
    q, k, v = _t(*_arrays(3, (2, H, 4 * BLOCK, D), 13), grad=True)
    idx = tsa.layout_gather(layout)
    idx_t = tsa.layout_gather(layout, transpose=True)
    block_sparse_flash_attention(q, k, v, *idx, *idx_t, BLOCK,
                                 causal=True).square().sum().backward()
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))


# ---------------------------------------------------------------------- #
# SparseSelfAttention vs the JAX module's gather path
# ---------------------------------------------------------------------- #
def _jax_gather_grads(module, q, k, v, causal, **masks):
    def loss(q_, k_, v_):
        out = module(q_, k_, v_, causal=causal, **masks)
        return jnp.sum(out * out), out
    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(
        *map(jnp.asarray, (q, k, v)))
    return out, grads


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("spec", CONFIGS, ids=CONFIG_IDS)
def test_sparse_self_attention_matches_jax(spec, causal):
    """Unmasked calls (the port runs block_sparse_flash_attention, the
    twins on the CPU) against SparseSelfAttention(impl='gather'): out and
    the grads of sum(out**2)."""
    jcfg, tcfg = _pair(spec)
    q, k, v = _arrays(3, (2, H, S, D), seed=21)
    ref, rgrads = _jax_gather_grads(jsa.SparseSelfAttention(jcfg,
                                                            impl="gather"),
                                    q, k, v, causal)
    tq, tk, tv = _t(q, k, v, grad=True)
    out = tsa.SparseSelfAttention(tcfg)(tq, tk, tv, causal=causal)
    out.square().sum().backward()
    _close(out.detach(), ref, OUT_TOL)
    for g, r in zip((tq.grad, tk.grad, tv.grad), rgrads):
        _close(g, r, GRAD_TOL)


def _kernel_route(monkeypatch):
    """SparseSelfAttention and the block-sparse wrappers take CPU tensors
    as if they lay on the card.  Returns the blocks of the calls that
    reached block_sparse_flash_attention: at a block the kernels tile, the
    call runs the plain twins; at any other it goes on to the kernel
    wrappers, which refuse the block as they do on the card."""
    module = tsa.sparse_self_attention
    monkeypatch.setattr(module, "use_kernel", lambda *t: True, raising=False)
    monkeypatch.setattr(tsa.block_sparse_flash, "use_kernel", lambda *t: True)
    monkeypatch.setattr(tsa.SparseSelfAttention, "gathered", 0,
                        raising=False)
    flash_calls = []

    def spy(*args, **kwargs):
        flash_calls.append(args[7])
        if args[7] % 64:
            return block_sparse_flash_attention(*args, **kwargs)
        with monkeypatch.context() as m:
            m.setattr(tsa.block_sparse_flash, "use_kernel", lambda *t: False)
            return block_sparse_flash_attention(*args, **kwargs)

    monkeypatch.setattr(module, "block_sparse_flash_attention", spy)
    return flash_calls


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("block", [16, 32])
def test_untileable_block_takes_the_gather_path_on_the_kernel_route(
        monkeypatch, block, causal):
    """On the kernel route (CUDA tensors; forced here on CPU ones), a
    layout block that kernels F and G cannot tile (16, SparsityConfig's
    default, and 32) runs the gather path, as the JAX module does, and is
    counted on `gathered`, once a call: out and the grads of sum(out**2)
    against the JAX module (fp32, rtol = atol = 1e-5 for out, 1e-4 for the
    grads).  Kernels F and G are never reached."""
    flash_calls = _kernel_route(monkeypatch)
    jcfg = jsa.FixedSparsityConfig(num_heads=2, block=block)
    tcfg = tsa.FixedSparsityConfig(num_heads=2, block=block)
    q, k, v = _arrays(3, (1, 2, 128, 8), seed=27 + block)
    ref, rgrads = _jax_gather_grads(jsa.SparseSelfAttention(jcfg), q, k, v,
                                    causal)
    attn = tsa.SparseSelfAttention(tcfg)
    tq, tk, tv = _t(q, k, v, grad=True)
    out = attn(tq, tk, tv, causal=causal)
    out.square().sum().backward()
    _close(out.detach(), ref, 1e-5)
    for g, r in zip((tq.grad, tk.grad, tv.grad), rgrads):
        _close(g, r, 1e-4)
    assert tsa.SparseSelfAttention.gathered == 1
    with torch.no_grad():
        attn(tq, tk, tv, causal=causal)
    assert tsa.SparseSelfAttention.gathered == 2
    assert flash_calls == []


def test_tileable_block_keeps_the_flash_route(monkeypatch):
    """On the kernel route a block of 64 still takes
    block_sparse_flash_attention (kernels F and G), and nothing is counted
    on `gathered`; on the CPU route a block of 16 takes it too (the plain
    twins take any block)."""
    flash_calls = _kernel_route(monkeypatch)
    cfg = tsa.FixedSparsityConfig(num_heads=2, block=64)
    q, k, v = _t(*_arrays(3, (1, 2, 128, 8), seed=28))
    tsa.SparseSelfAttention(cfg)(q, k, v, causal=True)
    assert flash_calls == [64]
    assert tsa.SparseSelfAttention.gathered == 0
    for module in (tsa.sparse_self_attention, tsa.block_sparse_flash):
        monkeypatch.setattr(module, "use_kernel", lambda *t: False)
    tsa.SparseSelfAttention(tsa.FixedSparsityConfig(num_heads=2))(q, k, v)
    assert flash_calls == [64, 16]
    assert tsa.SparseSelfAttention.gathered == 0


def _masks(kp_mode, attn_mode, seed):
    rs = np.random.RandomState(seed)
    rpe = (rs.randn(H, S, S) * 0.5).astype(np.float32)
    if kp_mode == "add":
        kp = np.where(rs.rand(2, S) < 0.2, -10000.0, 0.0).astype(np.float32)
    else:
        kp = (rs.rand(2, S) >= 0.2).astype(np.float32)
    if attn_mode == "add":
        attn = np.triu(np.full((S, S), -10000.0, np.float32), k=1)
    else:
        attn = np.tril(np.ones((S, S), np.float32))
    return rpe, kp, attn


@pytest.mark.parametrize("kp_mode,attn_mode", [("add", "add"), ("mul", "mul"),
                                               ("add", "mul")])
def test_masked_sparse_attention_matches_jax(kp_mode, attn_mode):
    """rpe + key-padding + attention masks in both modes: the port's gather
    path against the JAX one, out and grads.  With both masks in 'mul'
    mode the JAX grads hold NaN at the entries of fully masked rows (the
    two stacked mask values overflow to -inf before the clamp); the
    port's are finite there and are compared where the JAX ones are."""
    jcfg, tcfg = _pair(CONFIGS[1])
    q, k, v = _arrays(3, (2, H, S, D), seed=22)
    rpe, kp, attn = _masks(kp_mode, attn_mode, seed=0)
    modes = dict(key_padding_mask_mode=kp_mode, attn_mask_mode=attn_mode)
    ref, rgrads = _jax_gather_grads(
        jsa.SparseSelfAttention(jcfg, **modes), q, k, v, False,
        rpe=jnp.asarray(rpe), key_padding_mask=jnp.asarray(kp),
        attn_mask=jnp.asarray(attn))
    tq, tk, tv = _t(q, k, v, grad=True)
    out = tsa.SparseSelfAttention(tcfg, **modes)(
        tq, tk, tv, rpe=torch.from_numpy(rpe),
        key_padding_mask=torch.from_numpy(kp),
        attn_mask=torch.from_numpy(attn))
    out.square().sum().backward()
    _close(out.detach(), ref, OUT_TOL)
    for g, r in zip((tq.grad, tk.grad, tv.grad), rgrads):
        r = np.asarray(r)
        finite = np.isfinite(r)
        assert torch.isfinite(g).all()
        assert finite.all() or (kp_mode, attn_mode) == ("mul", "mul")
        _close(g.numpy()[finite], r[finite], GRAD_TOL)


def test_double_mul_mask_fully_masked_row_is_zero():
    _, tcfg = _pair(CONFIGS[1])
    q, k, v = _t(*_arrays(3, (2, H, S, D), seed=23))
    kp = torch.ones(2, S)
    kp[0] = 0.0
    attn = torch.zeros(S, S)
    out = tsa.SparseSelfAttention(tcfg, key_padding_mask_mode="mul",
                                  attn_mask_mode="mul")(
        q, k, v, key_padding_mask=kp, attn_mask=attn)
    assert torch.isfinite(out).all() and (out[0] == 0).all()


def test_layout_tensors_are_built_once_per_length():
    """The layout and its index tensors are cached per (length, device):
    a second call copies nothing, and a call launches no kernel on the
    CPU (the twins run)."""
    _, tcfg = _pair(CONFIGS[4])
    attn = tsa.SparseSelfAttention(tcfg)
    first = attn.layout_for(S, "cpu")
    assert attn.layout_for(S, "cpu") is first
    assert all(t.dtype == torch.int32 for t in first[3])
    reset_launch_counts()
    q, k, v = _t(*_arrays(3, (2, H, S, D), seed=24))
    out = attn(q, k, v, causal=True)
    ref = block_sparse_flash_attention(q, k, v, *tsa.layout_gather(first[0]),
                                       *tsa.layout_gather(first[0], True),
                                       BLOCK, causal=True)
    assert torch.equal(out, ref)
    assert set(launch_counts().values()) == {0}
    assert attn.density(S) == pytest.approx(float(first[0].mean()))


# ---------------------------------------------------------------------- #
# refusals
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("impl", ["pallas", "gather", "xla"])
def test_impl_switch_is_refused(impl):
    _, tcfg = _pair(CONFIGS[1])
    with pytest.raises(ValueError, match="dispatch.py"):
        tsa.SparseSelfAttention(tcfg, impl=impl)


@pytest.mark.parametrize("launch", ["fwd", "dq", "dkdv"])
def test_untileable_block_is_refused_by_the_kernels(launch):
    """A layout block that is not a multiple of the kernels' 64-row tile
    raises from the kernel wrappers (before any device check), naming the
    rule: it never drops to the plain twin."""
    layout = tsa.FixedSparsityConfig(num_heads=H, block=BLOCK).make_layout(S)
    idx, valid = _t(*tsa.layout_gather(layout))
    q, k, v, do = _t(*_arrays(4, (2, H, S, D), seed=25))
    stats = torch.zeros(2, H, S)
    call = {"fwd": lambda: block_sparse_flash_fwd_cuda(q, k, v, idx, valid,
                                                        BLOCK),
            "dq": lambda: block_sparse_flash_bwd_dq_cuda(
                q, k, v, do, stats, stats, idx, valid, BLOCK),
            "dkdv": lambda: block_sparse_flash_bwd_dkdv_cuda(
                q, k, v, do, stats, stats, idx, valid, BLOCK)}[launch]
    with pytest.raises(ValueError, match="multiple of 64"):
        call()


def test_bad_modes_and_heads_are_refused():
    _, tcfg = _pair(CONFIGS[1])
    with pytest.raises(ValueError, match="add\\|mul"):
        tsa.SparseSelfAttention(tcfg, key_padding_mask_mode="max")
    q, k, v = _t(*_arrays(3, (2, H + 1, S, D), seed=26))
    with pytest.raises(ValueError, match="heads"):
        tsa.SparseSelfAttention(tcfg)(q, k, v)
    with pytest.raises(ValueError, match="divisible"):
        tcfg.make_layout(100)


# ---------------------------------------------------------------------- #
# MatMul, Softmax, BertSparseSelfAttention, helpers
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("mode,trans_a,trans_b", [
    ("sdd", False, True), ("sdd", False, False), ("dsd", False, False),
    ("dsd", True, False), ("dds", False, False), ("dds", False, True)])
def test_block_sparse_matmul_matches_jax(mode, trans_a, trans_b):
    """Each mode on the same operands, outputs and the grads of a sum of
    squares; sparse operands come from the sdd product."""
    jcfg, _ = _pair(CONFIGS[1])
    layout = jcfg.make_layout(S)
    a, b = _arrays(2, (2, H, S, D), seed=31)
    jsdd = jsa.MatMul(layout, BLOCK, "sdd", trans_b=True)
    tsdd = tsa.MatMul(layout, BLOCK, "sdd", trans_b=True)
    jw = jsdd(jnp.asarray(a), jnp.asarray(b))
    jop = jsa.MatMul(layout, BLOCK, mode, trans_a, trans_b)
    top = tsa.MatMul(layout, BLOCK, mode, trans_a, trans_b)
    if mode == "sdd":
        dense = (a, b) if trans_b else (a, np.swapaxes(b, -1, -2).copy())
        jargs = list(map(jnp.asarray, dense))
        targs = _t(*dense, grad=True)
    elif mode == "dsd":
        jargs = [jw, jnp.asarray(b)]
        targs = _t(np.asarray(jw), b, grad=True)
    else:
        c = np.swapaxes(a, -1, -2).copy()
        jargs = [jnp.asarray(c), jw]
        targs = _t(c, np.asarray(jw), grad=True)
    ref, rgrads = jax.value_and_grad(
        lambda x, y: jnp.sum(jop(x, y) ** 2), argnums=(0, 1))(*jargs)
    out = top(*targs)
    out.square().sum().backward()
    np.testing.assert_allclose(out.square().sum().item(), float(ref),
                               rtol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jop(*jargs)), rtol=1e-5, atol=1e-5)
    for g, r in zip((targs[0].grad, targs[1].grad), rgrads):
        _close(g / np.abs(np.asarray(r)).max(),
               np.asarray(r) / np.abs(np.asarray(r)).max(), 1e-5)
    np.testing.assert_array_equal(
        np.stack(tsa.block_coords(layout)), np.stack(jsa.block_coords(layout)))
    tw = tsdd(*_t(a, b))
    _close(tw, jw, 1e-5)


@pytest.mark.parametrize("kp_mode,attn_mode", [("add", "add"),
                                               ("mul", "mul")])
def test_block_sparse_softmax_matches_jax(kp_mode, attn_mode):
    jcfg, _ = _pair(CONFIGS[1])
    layout = jcfg.make_layout(S)
    q, k = _arrays(2, (2, H, S, D), seed=32)
    w = np.array(jsa.MatMul(layout, BLOCK, "sdd", trans_b=True)(
        jnp.asarray(q), jnp.asarray(k)))
    rpe, kp, attn = _masks(kp_mode, attn_mode, seed=1)
    kw = dict(scale=1.0 / np.sqrt(D), key_padding_mask_mode=kp_mode,
              attn_mask_mode=attn_mode)
    ref = jsa.Softmax(layout, BLOCK)(
        jnp.asarray(w), rpe=jnp.asarray(rpe),
        key_padding_mask=jnp.asarray(kp), attn_mask=jnp.asarray(attn), **kw)
    out = tsa.Softmax(layout, BLOCK)(
        torch.from_numpy(w), rpe=torch.from_numpy(rpe),
        key_padding_mask=torch.from_numpy(kp),
        attn_mask=torch.from_numpy(attn), **kw)
    _close(out, ref, OUT_TOL)


@dataclass
class _BertCfg:
    hidden_size: int = H * D
    num_attention_heads: int = H


@pytest.mark.parametrize("mode", ["add", "mul"])
def test_bert_sparse_self_attention_matches_jax(mode):
    jcfg, tcfg = _pair(("FixedSparsityConfig", dict(num_local_blocks=4)))
    jmod = jsa.BertSparseSelfAttention(_BertCfg(), jcfg,
                                       key_padding_mask_mode=mode)
    params = jax.tree.map(np.asarray, jmod.init_params(jax.random.PRNGKey(0)))
    tmod = tsa.BertSparseSelfAttention(_BertCfg(), tcfg,
                                       key_padding_mask_mode=mode)
    tmod.load_state_dict({f"{p}.{leaf}": torch.from_numpy(params[p][leaf])
                          for p in params for leaf in params[p]})
    (hidden,) = _arrays(1, (2, S, H * D), seed=33)
    mask = np.zeros((2, S), np.float32) if mode == "add" else \
        np.ones((2, S), np.float32)
    mask[:, S // 2:] = -10000.0 if mode == "add" else 0.0
    ref = jmod.apply(params, jnp.asarray(hidden),
                     attention_mask=jnp.asarray(mask))
    with torch.no_grad():
        out = tmod(torch.from_numpy(hidden),
                   attention_mask=torch.from_numpy(mask))
    _close(out, ref, OUT_TOL)
    with pytest.raises(ValueError, match="heads"):
        tsa.BertSparseSelfAttention(_BertCfg(), tsa.FixedSparsityConfig(
            num_heads=H + 1))


def test_pad_unpad_and_position_embedding_match_jax():
    ids = np.ones((2, 30), np.int32)
    for pkg, conv in ((jsa, jnp.asarray), (tsa, torch.from_numpy)):
        pad, pids, pmask = pkg.pad_to_block_size(16, conv(ids), 0,
                                                 attention_mask=conv(ids))
        assert pad == 2 and tuple(pids.shape) == (2, 32)
        assert int(pids[0, -1]) == 0 and int(pmask[0, -1]) == 0
        assert tuple(pkg.unpad_sequence_output(pad, pids).shape) == (2, 30)
    (wpe,) = _arrays(1, (32, 16), seed=34)
    ref = jsa.extend_position_embedding({"wpe": jnp.asarray(wpe)}, 128)
    out = tsa.extend_position_embedding({"wpe": torch.from_numpy(wpe)}, 128)
    np.testing.assert_array_equal(out["wpe"].numpy(), np.asarray(ref["wpe"]))
    with pytest.raises(ValueError, match="multiple"):
        tsa.extend_position_embedding({"wpe": torch.from_numpy(wpe)}, 100)


# ---------------------------------------------------------------------- #
# the sparse transformer layer and its mask routing
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("mask", [None, "key_padding", "attn"])
def test_sparse_layer_matches_jax(mask):
    """DeepSpeedTransformerLayer with a sparsity_config against the JAX
    layer on the same weights: [B,1,1,S] routes to the key-padding mask,
    [S,S] to the attention mask; a [B,1,S,S] mask is refused."""
    jsparse, tsparse = _pair(CONFIGS[1])
    kw = dict(hidden_size=H * D, heads=H, attn_dropout_ratio=0.0,
              hidden_dropout_ratio=0.0, bf16=False)
    jlayer = JaxLayer(JaxLayerConfig(sparsity_config=jsparse, **kw))
    params = jax.tree.map(np.asarray, jlayer.init_params(
        jax.random.PRNGKey(0)))
    layer = DeepSpeedTransformerLayer(DeepSpeedTransformerConfig(
        sparsity_config=tsparse, **kw))
    layer.load_state_dict({n: torch.from_numpy(a) for n, a in params.items()})
    (x,) = _arrays(1, (2, S, H * D), seed=35)
    am = None
    if mask == "key_padding":
        am = np.zeros((2, 1, 1, S), np.float32)
        am[..., S // 2:] = -10000.0
    elif mask == "attn":
        am = np.triu(np.full((S, S), -10000.0, np.float32), k=1)
    ref = jlayer(params, jnp.asarray(x),
                 attn_mask=None if am is None else jnp.asarray(am),
                 deterministic=True)
    with torch.no_grad():
        out = layer(torch.from_numpy(x),
                    attn_mask=None if am is None else torch.from_numpy(am),
                    deterministic=True)
    _close(out, ref, 1e-4)
    with pytest.raises(NotImplementedError, match="2D"):
        layer(torch.from_numpy(x), attn_mask=torch.zeros(2, 1, S, S),
              deterministic=True)
