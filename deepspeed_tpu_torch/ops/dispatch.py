"""Kernel dispatch (counterpart of deepspeed_tpu/ops/dispatch.py).

One rule, read from the tensors themselves: a CPU tensor takes the
kernel's plain PyTorch version, a CUDA tensor takes the hand-written
kernel (or the wrapper raises), and any other device raises.  There is no
switch and no fallback: a kernel that cannot build or launch fails the
call.  (The JAX package's TPU switches, DS_FORCE_XLA_OPS, DS_LN_IMPL and
the flash AUTO_MIN_SEQ crossover, were set by v5e measurements and have no
counterpart here.)
"""

import torch

from .op_builder import DTYPE_BF16, DTYPE_FP16, DTYPE_FP32

# The checks below run on every launch, and eager decode is bound by the
# host (PERF.md), so they use the cheapest tensor attributes there are.

def use_kernel(*tensors: torch.Tensor) -> bool:
    """True when the tensors lie on a CUDA device (launch the kernel; the
    wrapper's check_cuda then holds every operand to that device), False
    when they all lie on the CPU (take the plain version)."""
    if tensors[0].is_cuda:
        return True
    for t in tensors:
        if t.device.type != "cpu":
            raise ValueError(
                f"no kernel or plain path for device type {t.device.type!r} "
                f"(operands on {t.device} and {tensors[0].device}; the port "
                "runs on 'cuda', and on 'cpu' for tests)")
    return False


# torch dtype -> csrc/common.cuh dtype code
DTYPE_CODES = {torch.float32: DTYPE_FP32, torch.bfloat16: DTYPE_BF16}
# the dtypes of kernels A's and D's gamma and beta: also fp16, which an fp16
# run's cast of the parameters gives them (every other operand of every
# kernel is bf16 or fp32)
PARAM_DTYPE_CODES = {**DTYPE_CODES, torch.float16: DTYPE_FP16}


def kernel_dtype_code(t: torch.Tensor) -> int:
    """The dtype code of csrc/common.cuh for a kernel operand; raises for
    a dtype the kernels do not take."""
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(
            f"the CUDA kernels take bfloat16 or float32, got {t.dtype}")
    return code


def check_cuda(name: str, *tensors: torch.Tensor) -> int:
    """A kernel wrapper's device check: every tensor on one CUDA device,
    the current one.  Returns that device's index."""
    index = tensors[0].get_device()
    for t in tensors:
        if not t.is_cuda or t.get_device() != index:
            raise ValueError(f"{name}: every operand must lie on one CUDA "
                             f"device, got {t.device} and {tensors[0].device}")
    # CUDA is initialised once a CUDA tensor exists: the raw query skips
    # torch.cuda.current_device()'s initialisation check
    current = torch._C._cuda_getDevice()
    if index != current:
        raise ValueError(f"{name}: operands lie on cuda:{index} but the "
                         f"current device is cuda:{current}")
    return index


def check_contiguous(name: str, **tensors: torch.Tensor) -> None:
    for arg, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: `{arg}` must be contiguous "
                             f"(shape {tuple(t.shape)}, strides {t.stride()})")


def stream_handle(index: int) -> int:
    """The current CUDA stream of device `index`, as the int ctypes passes.
    The raw query builds no torch.cuda.Stream object, as
    torch.cuda.current_stream() does on every call."""
    return torch._C._cuda_getCurrentRawStream(index)
