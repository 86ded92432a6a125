"""LayerNorm: the PyTorch port (deepspeed_tpu_torch.ops.normalize) against
the JAX package's Pallas kernel (interpret mode) and plain reference, on the
same numpy inputs, forward (kernel A) and backward (kernel D).  On the CPU
the port runs the plain versions; the CUDA kernels themselves are held
against them on the card by chip_smoke.py."""

import ctypes
import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deepspeed_tpu.ops.normalize import layer_norm_pallas
from deepspeed_tpu.ops.normalize import layer_norm_reference as jax_ln_reference
from deepspeed_tpu_torch.ops import dispatch, op_builder
from deepspeed_tpu_torch.ops.normalize import (LN_MAX_ROW_THREADS, LN_ROUTES,
                                               LN_BWD_BLOCKS, LN_FWD_BLOCKS,
                                               LN_SCALAR_CAP, LN_SLOT_THREADS,
                                               LN_STREAM_THREADS,
                                               LN_VECTOR_CAP, fused_layer_norm,
                                               layer_norm_bwd_cuda,
                                               layer_norm_bwd_reference,
                                               layer_norm_cuda, layer_norm_plan,
                                               layer_norm_reference)

# the module (ops/__init__ exports a function under a similar name)
nz = importlib.import_module("deepspeed_tpu_torch.ops.normalize")


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3.0 + 0.5).astype(np.float32)
    gamma = (rng.standard_normal(shape[-1]) + 1.0).astype(np.float32)
    beta = rng.standard_normal(shape[-1]).astype(np.float32)
    return x, gamma, beta


@pytest.mark.parametrize("shape", [(4, 96, 256), (16, 32), (8, 768),
                                   # GPT-2 XL's width, a 4096 row (the
                                   # widths kernel D refused before it kept
                                   # its column sums in registers), an odd
                                   # width (the scalar route)
                                   (8, 1600), (4, 4096), (8, 771)])
def test_fused_layer_norm_matches_pallas_interpret(shape):
    """fp32, atol = rtol = 1e-5 (same statistics, summation order aside)."""
    x, g, b = _inputs(shape)
    ref = layer_norm_pallas(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                            interpret=True)
    out = fused_layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                           torch.from_numpy(b))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("eps", [1e-5, 1e-3])
def test_layer_norm_reference_matches_jax_reference(eps):
    x, g, b = _inputs((6, 48), seed=1)
    ref = jax_ln_reference(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                           eps)
    out = layer_norm_reference(torch.from_numpy(x), torch.from_numpy(g),
                               torch.from_numpy(b), eps)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_fused_layer_norm_bf16_matches_jax():
    """bf16 activations, fp32 gamma/beta (the serving layout); atol = rtol
    = 2e-2, the chip-lane bf16 tolerance."""
    x, g, b = _inputs((8, 2, 768), seed=2)
    ref = jax_ln_reference(jnp.asarray(x, jnp.bfloat16), jnp.asarray(g),
                           jnp.asarray(b))
    out = fused_layer_norm(torch.from_numpy(x).to(torch.bfloat16),
                           torch.from_numpy(g), torch.from_numpy(b))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


def test_cpu_tensors_take_the_plain_path_and_the_wrapper_refuses_them():
    x, g, b = _inputs((4, 64), seed=3)
    xt, gt, bt = map(torch.from_numpy, (x, g, b))
    before = layer_norm_cuda.launches
    fused_layer_norm(xt, gt, bt)
    assert layer_norm_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        layer_norm_cuda(xt, gt, bt)
    with pytest.raises(ValueError, match="device type 'meta'"):
        dispatch.use_kernel(torch.empty(2, device="meta"))


# ---------------------------------------------------------------------- #
# backward: kernel D's plain twin and the autograd.Function
# ---------------------------------------------------------------------- #
def _bwd_inputs(shape, seed):
    x, g, b = _inputs(shape, seed)
    dy = np.random.default_rng(seed + 100).standard_normal(shape).astype(
        np.float32)
    return x, g, b, dy


@pytest.mark.parametrize("shape", [(4, 64, 256), (16, 32), (8, 768),
                                   (8, 1600), (4, 4096), (8, 771)])
def test_layer_norm_bwd_matches_pallas_interpret(shape):
    """layer_norm_bwd_reference (kernel D's twin) vs
    layer_norm_bwd_pallas(interpret=True): dx, dgamma, dbeta, fp32 1e-5
    (dgamma / dbeta relative to their largest entry, being sums over up to
    16384 rows)."""
    from deepspeed_tpu.ops.normalize import layer_norm_bwd_pallas
    x, g, _, dy = _bwd_inputs(shape, seed=4)
    ref = layer_norm_bwd_pallas(jnp.asarray(x), jnp.asarray(g),
                                jnp.asarray(dy), interpret=True)
    out = layer_norm_bwd_reference(torch.from_numpy(x), torch.from_numpy(g),
                                   torch.from_numpy(dy))
    for o, r in zip(out, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(o.numpy(), r, rtol=1e-5,
                                   atol=1e-5 * np.abs(r).max())


def test_fused_layer_norm_grads_match_jax_vjp():
    """fused_layer_norm's autograd (the plain pair on the CPU) vs
    jax.vjp(layer_norm_reference): dx, dgamma, dbeta at fp32 1e-5."""
    import jax
    x, g, b, dy = _bwd_inputs((6, 10, 96), seed=5)
    _, vjp = jax.vjp(lambda x_, g_, b_: jax_ln_reference(x_, g_, b_),
                     jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    ref = vjp(jnp.asarray(dy))
    xt, gt, bt = (torch.from_numpy(t).requires_grad_() for t in (x, g, b))
    fused_layer_norm(xt, gt, bt).backward(torch.from_numpy(dy))
    for o, r in zip((xt.grad, gt.grad, bt.grad), ref):
        r = np.asarray(r)
        np.testing.assert_allclose(o.numpy(), r, rtol=1e-5,
                                   atol=1e-5 * np.abs(r).max())


def test_fused_layer_norm_bf16_grads_match_jax_vjp():
    """bf16 x and dy, bf16 gamma/beta (the training engine casts every
    parameter to the compute dtype): dx in bf16, dgamma/dbeta reduced in
    fp32 and returned in the parameters' dtype; atol = rtol = 2e-2 relative
    to each grad's largest entry."""
    import jax
    x, g, b, dy = _bwd_inputs((8, 4, 768), seed=6)
    bf = jnp.bfloat16
    _, vjp = jax.vjp(lambda x_, g_, b_: jax_ln_reference(x_, g_, b_),
                     jnp.asarray(x, bf), jnp.asarray(g, bf),
                     jnp.asarray(b, bf))
    ref = vjp(jnp.asarray(dy, bf))
    xt, gt, bt = (torch.from_numpy(t).to(torch.bfloat16).requires_grad_()
                  for t in (x, g, b))
    fused_layer_norm(xt, gt, bt).backward(
        torch.from_numpy(dy).to(torch.bfloat16))
    for o, r in zip((xt.grad, gt.grad, bt.grad), ref):
        assert o.dtype == torch.bfloat16
        r = np.asarray(r.astype(jnp.float32))
        np.testing.assert_allclose(o.float().numpy(), r, rtol=2e-2,
                                   atol=2e-2 * np.abs(r).max())


def test_layer_norm_bwd_wrapper_refuses_cpu_tensors():
    x, g, _, dy = (torch.from_numpy(t) for t in _bwd_inputs((4, 64), seed=7))
    with pytest.raises(ValueError, match="CUDA"):
        layer_norm_bwd_cuda(x, g, dy)


@pytest.mark.parametrize("hidden", [1600, 771])
def test_fused_layer_norm_bf16_param_grads_match_jax_vjp_at_more_widths(
        hidden):
    """The training layout (bf16 x, dy, gamma and beta) at GPT-2 XL's width
    and an odd one: dgamma / dbeta come back in bf16, within 2e-2 of
    jax.vjp(layer_norm_reference) relative to each grad's largest entry."""
    import jax
    x, g, b, dy = _bwd_inputs((4, 3, hidden), seed=hidden)
    bf = jnp.bfloat16
    _, vjp = jax.vjp(lambda x_, g_, b_: jax_ln_reference(x_, g_, b_),
                     jnp.asarray(x, bf), jnp.asarray(g, bf),
                     jnp.asarray(b, bf))
    ref = vjp(jnp.asarray(dy, bf))
    xt, gt, bt = (torch.from_numpy(t).to(torch.bfloat16).requires_grad_()
                  for t in (x, g, b))
    fused_layer_norm(xt, gt, bt).backward(
        torch.from_numpy(dy).to(torch.bfloat16))
    for o, r in zip((gt.grad, bt.grad), ref[1:]):
        assert o.dtype == torch.bfloat16
        r = np.asarray(r.astype(jnp.float32))
        np.testing.assert_allclose(o.float().numpy(), r, rtol=2e-2,
                                   atol=2e-2 * np.abs(r).max())


# ---------------------------------------------------------------------- #
# layer_norm_plan: kernels A's and D's launch, mirrored from
# csrc/layer_norm_row.cuh plan() (chip_smoke.py holds the two equal)
# ---------------------------------------------------------------------- #
BF16, FP32 = op_builder.DTYPE_BF16, op_builder.DTYPE_FP32
SMS = 132  # an H100 SXM's


@pytest.mark.parametrize("code", [BF16, FP32])
@pytest.mark.parametrize("backward", [False, True])
def test_every_hidden_size_gets_a_route_that_covers_its_row(code, backward):
    """Every hidden from 1 to 20000 (and a few wider) has a plan: the vector
    route's 16-byte packs where the width is a multiple of the pack and the
    tensors are aligned, element packs otherwise, the streamed route past
    the registers of LN_MAX_ROW_THREADS threads; the row's threads hold
    every column, a block holds at most LN_SLOT_THREADS threads of rows
    narrower than that, and the blocks cover every row.  hidden 0 raises."""
    vec = 8 if code == BF16 else 4
    for hidden in list(range(1, 20001)) + [32768, 32769, 65536, 100003]:
        for aligned in (True, False):
            p = layer_norm_plan(77, hidden, code, aligned, backward)
            assert p.route in LN_ROUTES
            assert p.threads_per_row % 32 == 0
            if p.route == "streamed":
                assert p.threads_per_row == LN_STREAM_THREADS
                assert p.per_thread == 0 and p.slots == 1
                cap = LN_VECTOR_CAP * vec if aligned and hidden % vec == 0 \
                    else LN_SCALAR_CAP
                assert hidden > LN_MAX_ROW_THREADS * cap
                continue
            width = vec if p.route == "vector" else 1
            assert p.route == ("vector" if aligned and hidden % vec == 0
                               else "scalar")
            assert p.threads_per_row <= LN_MAX_ROW_THREADS
            assert p.threads_per_row * p.per_thread * width >= hidden
            assert (p.threads_per_row - 32) * p.per_thread * width < hidden
            assert p.slots * p.threads_per_row <= max(LN_SLOT_THREADS,
                                                      p.threads_per_row)
            assert p.blocks * p.rows_per_block >= 77
            assert p.chunks == (p.blocks if backward else 0)
    with pytest.raises(ValueError, match="hidden 0"):
        layer_norm_plan(8, 0, code)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("hidden,code", [
    (768, BF16), (771, FP32), (8192, FP32), (12288, FP32), (16385, BF16),
    (20000, BF16)])
def test_the_kernels_take_every_row_once_on_every_route(hidden, code,
                                                        backward):
    """The rows the kernels take under a plan: slot s of block b takes rows
    b * rows_per_block + s + i * slots, i < rows_per_slot, those below
    rows (ln_fwd_kernel, ln_bwd_kernel; the streamed kernels hold one slot,
    so rows b * rows_per_slot + i).  Every row is taken once, on every
    route, also at row counts that give each slot several rows (on the
    streamed route A's past 264 rows, D's past 132)."""
    for rows in list(range(1, 600)) + [1023, 1024, 1025, 8192, 16384, 33000]:
        p = layer_norm_plan(rows, hidden, code, True, backward)
        if p.route == "streamed":
            assert p.slots == 1
        taken = [b * p.rows_per_block + s + i * p.slots
                 for b in range(p.blocks) for s in range(p.slots)
                 for i in range(p.rows_per_slot)]
        assert sorted(r for r in taken if r < rows) == list(range(rows))
    assert layer_norm_plan(33000, hidden, code, True,
                           backward).rows_per_slot > 1


def test_the_plan_reads_no_device_so_d_sums_in_one_order_on_any_card(
        monkeypatch):
    """The row partition of kernel D (its chunks, one fp32 workspace row a
    block, summed in a fixed order) is a function of rows and hidden: the
    plan reads nothing of the device, not even whether there is one, so
    dgamma and dbeta repeat bitwise on any H100 whatever its SM count.  At
    the training step's rows: 128 chunks of 64 rows (8 rows at once, 8 each
    one after another), and train_longseq's twice the rows per chunk."""
    def no_device(*args, **kwargs):
        raise AssertionError("the plan asked the device")
    for fn in ("device_count", "get_device_properties", "current_device",
               "is_available"):
        monkeypatch.setattr(torch.cuda, fn, no_device)
    p = layer_norm_plan(8192, 768, BF16, True, True)
    assert (p.route, p.threads_per_row, p.per_thread) == ("vector", 32, 3)
    assert (p.slots, p.rows_per_slot, p.chunks) == (8, 8, 128)
    p = layer_norm_plan(16384, 768, BF16, True, True)
    assert (p.slots, p.rows_per_slot, p.chunks) == (8, 16, 128)
    # constants, not the card's count: D one block per SM of an H100 SXM,
    # A two
    assert (LN_BWD_BLOCKS, LN_FWD_BLOCKS) == (SMS, 2 * SMS)


def test_decode_and_prefill_rows_spread_over_more_than_one_wave():
    """Few rows take one row a block: decode's [8, 768] runs 8 blocks (8
    SMs, where 8 rows a block ran on one), prefill's [1024, 768] runs 256
    blocks of 4 rows, more than one block for each of the 132 SMs; the
    train step's [8192, 768] holds 8 rows a block at once and takes 4 each
    (256 blocks)."""
    p = layer_norm_plan(8, 768, BF16)
    assert (p.blocks, p.slots, p.threads_per_row) == (8, 1, 32)
    p = layer_norm_plan(1024, 768, BF16)
    assert p.blocks == 256 > SMS and (p.slots, p.rows_per_slot) == (4, 1)
    assert layer_norm_plan(1024, 768, FP32).blocks == 256
    p = layer_norm_plan(8192, 768, BF16)
    assert (p.blocks, p.slots, p.rows_per_slot) == (256, 8, 4)


@pytest.mark.parametrize("hidden,code,route,tpr,per", [
    (768, BF16, "vector", 32, 3), (768, FP32, "vector", 64, 3),
    (1024, BF16, "vector", 32, 4), (1600, BF16, "vector", 64, 4),
    (4096, BF16, "vector", 128, 4), (4096, FP32, "vector", 256, 4),
    (8192, BF16, "vector", 256, 4), (8192, FP32, "vector", 512, 4),
    (771, BF16, "scalar", 64, 16), (8191, FP32, "scalar", 512, 16),
    (8193, FP32, "streamed", 1024, 0),
    (16384, BF16, "vector", 512, 4), (16385, BF16, "streamed", 1024, 0),
    (8200, FP32, "streamed", 1024, 0), (1, FP32, "scalar", 32, 1)])
def test_the_routes_at_the_widths_the_chip_run_holds(hidden, code, route, tpr,
                                                    per):
    """A row sits in one warp up to 1024 bf16 elements (GPT-2's 768: 3
    packs of 8 a lane) and is split over the warps of a block above; an odd
    width takes element loads, and a row too wide for 16 warps' registers
    is streamed."""
    p = layer_norm_plan(8, hidden, code)
    assert (p.route, p.threads_per_row, p.per_thread) == (route, tpr, per)


def test_a_misaligned_base_takes_the_scalar_route():
    assert layer_norm_plan(8, 768, BF16, aligned=False).route == "scalar"
    assert layer_norm_plan(8, 768, BF16, aligned=True).route == "vector"
    assert layer_norm_plan(8, 772, BF16).route == "scalar"
    assert layer_norm_plan(8, 772, FP32).route == "vector"


# ---------------------------------------------------------------------- #
# the wrappers up to the launch, against a stand-in kernel library
# ---------------------------------------------------------------------- #
def _at(ptr, shape, dtype):
    """The contiguous tensor of `shape` at CPU address ptr (what a kernel
    reads and writes there)."""
    numel = int(np.prod(shape))
    size = torch.empty((), dtype=dtype).element_size()
    raw = (ctypes.c_char * (numel * size)).from_address(ptr)
    return torch.frombuffer(raw, dtype=dtype).view(shape)


def _dtype(code):
    return {BF16: torch.bfloat16, op_builder.DTYPE_FP16: torch.float16}.get(
        code, torch.float32)


class _Kernels:
    """Stand-in for the kernel library's LayerNorm launchers: each reads its
    operands back from the pointers the wrapper hands it, in the dtypes its
    codes name, writes the plain twin's result through the output pointers
    (dgamma and dbeta rounded once into gamma's dtype), and records the
    call.  While it computes, the wrappers' guard (`busy`) is set."""

    def __init__(self):
        self.calls = []
        self.busy = False

    def ds_layer_norm_fwd(self, x, g, b, out, eps, launch, _stream):
        rows, hidden, code, pcode, *plan = launch
        self.busy = True
        xt = _at(x, (rows, hidden), _dtype(code))
        gt, bt = (_at(p, (hidden,), _dtype(pcode)) for p in (g, b))
        _at(out, (rows, hidden), _dtype(code)).copy_(
            layer_norm_reference(xt, gt, bt, eps))
        self.busy = False
        self.calls.append({"fn": "fwd", "gamma": g, "beta": b, "pcode": pcode,
                           "plan": tuple(plan), "shape": (rows, hidden, code)})
        return 0

    def ds_layer_norm_bwd(self, x, g, dy, dx, ws, dg, db, eps, launch,
                          _stream):
        rows, hidden, code, pcode, *plan = launch
        self.busy = True
        dt, pt = _dtype(code), _dtype(pcode)
        ref = layer_norm_bwd_reference(_at(x, (rows, hidden), dt),
                                       _at(g, (hidden,), pt),
                                       _at(dy, (rows, hidden), dt), eps)
        _at(dx, (rows, hidden), dt).copy_(ref[0])
        _at(dg, (hidden,), pt).copy_(ref[1])
        _at(db, (hidden,), pt).copy_(ref[2])
        self.busy = False
        self.calls.append({"fn": "bwd", "gamma": g, "pcode": pcode,
                           "plan": tuple(plan), "shape": (rows, hidden, code)})
        return 0


@pytest.fixture
def ln_kernels(monkeypatch):
    """The LayerNorm wrappers with CPU tensors taken as if they lay on the
    card, their launches going to a _Kernels stand-in; and a count of every
    tensor the wrappers make by a cast, a copy or a fill (`.to`, `.float`,
    `.contiguous` returning a new tensor, `torch.zeros`, `zero_`, `fill_`)
    outside the stand-in: each would be a device kernel on the card."""
    lib = _Kernels()
    made = []
    monkeypatch.setattr(op_builder, "load", lambda: lib)
    monkeypatch.setattr(nz, "check_cuda", lambda name, *t: 0)
    monkeypatch.setattr(nz, "stream_handle", lambda index: 0)
    monkeypatch.setattr(nz, "use_kernel", lambda *t: True)

    def counted(name, fn, new_tensor):
        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            if not lib.busy and new_tensor(args, out):
                made.append(name)
            return out
        return wrapper
    for name in ("to", "float", "contiguous"):
        monkeypatch.setattr(torch.Tensor, name, counted(
            name, getattr(torch.Tensor, name), lambda a, o: o is not a[0]))
    for name in ("zero_", "fill_"):
        monkeypatch.setattr(torch.Tensor, name, counted(
            name, getattr(torch.Tensor, name), lambda a, o: True))
    for name in ("zeros", "zeros_like", "full"):
        monkeypatch.setattr(torch, name, counted(
            name, getattr(torch, name), lambda a, o: True))
    lib.made = made
    yield lib


@pytest.mark.parametrize("xdt,pdt", [(torch.bfloat16, torch.float32),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.float32, torch.float32),
                                     (torch.float32, torch.bfloat16)])
def test_the_wrappers_pass_gamma_and_beta_as_they_are(ln_kernels, xdt, pdt):
    """Kernel A's and D's wrappers hand the launch gamma's and beta's own
    memory with their own dtype code (bf16 in training, fp32 in serving),
    make no cast, copy or fill on the way (no zero-filled dgamma / dbeta:
    the second launch writes every column), pass the plan layer_norm_plan
    makes, and D returns dgamma and dbeta in gamma's dtype; the results
    are the plain twins'."""
    x, g, b, dy = (torch.from_numpy(t) for t in _bwd_inputs((8, 768),
                                                             seed=11))
    x, dy, g, b = x.to(xdt), dy.to(xdt), g.to(pdt), b.to(pdt)
    ln_kernels.made.clear()
    out = layer_norm_cuda(x, g, b)
    dx, dg, db = layer_norm_bwd_cuda(x, g, dy)
    assert ln_kernels.made == []
    fwd, bwd = ln_kernels.calls
    assert (fwd["gamma"], fwd["beta"], bwd["gamma"]) == (
        g.data_ptr(), b.data_ptr(), g.data_ptr())
    assert fwd["pcode"] == bwd["pcode"] == (BF16 if pdt == torch.bfloat16
                                            else FP32)
    code = BF16 if xdt == torch.bfloat16 else FP32
    for call, backward in ((fwd, False), (bwd, True)):
        p = layer_norm_plan(8, 768, code, True, backward)
        assert call["plan"] == p.launch_args == (
            LN_ROUTES.index(p.route), p.threads_per_row, p.rows_per_block,
            p.blocks)
    assert dg.dtype == db.dtype == pdt and dx.dtype == xdt
    assert torch.equal(out, layer_norm_reference(x, g, b))
    ref = layer_norm_bwd_reference(x, g, dy)
    assert torch.equal(dx, ref[0])
    assert torch.equal(dg, ref[1].to(pdt)) and torch.equal(db, ref[2].to(pdt))


def test_the_train_layout_autograd_makes_no_cast_or_fill(ln_kernels):
    """fused_layer_norm's autograd on the training layout (bf16 x, gamma,
    beta): the forward is one launch and the backward one, with no cast,
    copy or fill around them, and the grads come back in bf16."""
    x, g, b, dy = (torch.from_numpy(t).to(torch.bfloat16)
                   for t in _bwd_inputs((4, 6, 768), seed=12))
    xt, gt, bt = (t.clone().requires_grad_() for t in (x, g, b))
    ln_kernels.made.clear()
    out = fused_layer_norm(xt, gt, bt)
    out.backward(dy)
    assert ln_kernels.made == []
    assert [c["fn"] for c in ln_kernels.calls] == ["fwd", "bwd"]
    assert ln_kernels.calls[0]["shape"] == (24, 768, BF16)
    assert gt.grad.dtype == bt.grad.dtype == torch.bfloat16


def test_a_mixed_or_strided_gamma_beta_pair_is_taken_in_fp32(ln_kernels):
    """Off the model's paths: a bf16 gamma beside an fp32 beta, or a
    strided gamma, is read as contiguous fp32 copies; the result is the
    plain twin's."""
    x, g, b, _ = (torch.from_numpy(t) for t in _bwd_inputs((8, 64), seed=13))
    out = layer_norm_cuda(x, g.to(torch.bfloat16), b)
    assert ln_kernels.calls[-1]["pcode"] == FP32
    assert torch.equal(out, layer_norm_reference(x, g.to(torch.bfloat16), b))
    wide = torch.stack([g, g], dim=1)[:, 0]
    assert not wide.is_contiguous()
    out = layer_norm_cuda(x, wide, b)
    assert torch.equal(out, layer_norm_reference(x, g, b))
