"""DeepSpeedCPUAdam — host Adam / AdamW over fp32 CPU tensors
(counterpart of deepspeed_tpu/ops/adam/cpu_adam.py).

The update runs in the native library csrc/host/host_adam.cpp
(auto-vectorized, split over std::threads), built by ops/op_builder.CPUAdamBuilder and called with
the tensors' `data_ptr()`: one call steps a contiguous span in place and
can write a round-to-nearest-even bf16 copy of the new parameters (the
device-bound copy of ZeRO-Offload).  The library is the JAX package's
source, so the two give the same bits.

There is no quiet fallback: if the library does not build or load,
`native_lib()` raises.  `adam_step_plain` is the same update in PyTorch,
the twin the tests hold the library against; nothing on the engine's path
calls it.

The library's thread count is set explicitly at load (the CPUs this
process may run on); `num_threads()` reads it back.
"""

import ctypes
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ...utils.tree import tree_flatten
from ..op_builder import CPUAdamBuilder

_NATIVE: Optional[ctypes.CDLL] = None


def _cpus() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        return os.cpu_count() or 1


def native_lib() -> ctypes.CDLL:
    """The host Adam library, built and loaded once a process, its thread
    count set.  Raises RuntimeError (with g++'s stderr) when it cannot be
    built."""
    global _NATIVE
    if _NATIVE is None:
        lib = CPUAdamBuilder().load()
        P = ctypes.c_void_p
        F = ctypes.c_float
        lib.ds_adam_step.argtypes = [P, P, P, P, ctypes.c_int64, F, F, F, F,
                                     F, ctypes.c_int64, ctypes.c_int]
        lib.ds_adam_step.restype = None
        lib.ds_adam_step_bf16.argtypes = lib.ds_adam_step.argtypes + [P]
        lib.ds_adam_step_bf16.restype = None
        lib.ds_adam_num_threads.restype = ctypes.c_int
        lib.ds_adam_set_num_threads.argtypes = [ctypes.c_int]
        lib.ds_adam_set_num_threads.restype = None
        lib.ds_adam_set_num_threads(_cpus())
        _NATIVE = lib
    return _NATIVE


def num_threads() -> int:
    """The threads of the native update."""
    return int(native_lib().ds_adam_num_threads())


def _check_span(name, t, numel, dtypes):
    if not isinstance(t, torch.Tensor) or t.device.type != "cpu" \
            or t.dtype not in dtypes or not t.is_contiguous() \
            or t.numel() != numel:
        raise ValueError(
            f"adam {name}: needs a contiguous CPU tensor of {numel} elements "
            f"and dtype {dtypes}, got "
            + (f"{t.dtype} {tuple(t.shape)} on {t.device}"
               f"{'' if t.is_contiguous() else ', strided'}"
               if isinstance(t, torch.Tensor) else type(t).__name__))


def adam_step_buffers(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                      g: torch.Tensor, *, lr: float, beta1: float,
                      beta2: float, eps: float, weight_decay: float,
                      step: int, adamw_mode: bool,
                      bf16_out: Optional[torch.Tensor] = None) -> None:
    """One fused Adam / AdamW update of contiguous fp32 CPU tensors, in
    place, by the native library; `bf16_out` (bf16, or int16 holding bf16
    bits) receives the new parameters rounded to bf16."""
    n = p.numel()
    f32 = (torch.float32,)
    for name, t in (("param", p), ("exp_avg", m), ("exp_avg_sq", v),
                    ("grad", g)):
        _check_span(name, t, n, f32)
    args = [p.data_ptr(), m.data_ptr(), v.data_ptr(), g.data_ptr(), n,
            float(lr), float(beta1), float(beta2), float(eps),
            float(weight_decay), int(step), 1 if adamw_mode else 0]
    lib = native_lib()
    if bf16_out is None:
        lib.ds_adam_step(*args)
    else:
        _check_span("bf16_out", bf16_out, n, (torch.bfloat16, torch.int16))
        lib.ds_adam_step_bf16(*args, bf16_out.data_ptr())


def adam_step_plain(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                    g: torch.Tensor, *, lr: float, beta1: float,
                    beta2: float, eps: float, weight_decay: float,
                    step: int, adamw_mode: bool,
                    bf16_out: Optional[torch.Tensor] = None) -> None:
    """adam_step_buffers in plain PyTorch (the JAX module's NumPy
    `_adam_step_numpy`): the twin the tests hold the library against.  The
    scalars are the library's, computed in fp32 (its bias corrections
    round as powf's do)."""
    f32 = np.float32
    bias1 = f32(1) - np.power(f32(beta1), f32(step))
    bias2_sqrt = np.sqrt(f32(1) - np.power(f32(beta2), f32(step)))
    step_size = float(f32(lr) / bias1)
    if not adamw_mode and weight_decay > 0:
        g = g + weight_decay * p
    m.mul_(beta1).add_(g, alpha=float(f32(1) - f32(beta1)))
    v.mul_(beta2).addcmul_(g, g, value=float(f32(1) - f32(beta2)))
    denom = v.sqrt() / float(bias2_sqrt) + eps
    if adamw_mode and weight_decay > 0:
        p.mul_(float(f32(1) - f32(lr) * f32(weight_decay)))
    p.sub_(step_size * (m / denom))
    if bf16_out is not None:
        bf16_out.view(torch.bfloat16).copy_(p.reshape(bf16_out.shape))


def _host_fp32(x) -> torch.Tensor:
    t = x.detach() if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))
    return t.to("cpu", torch.float32, copy=True).contiguous()


class DeepSpeedCPUAdam:
    """Adam / AdamW stepping fp32 host copies of a tree's leaves in place
    (the JAX module's class over torch tensors).

    params: a tree (nested dicts, lists) of tensors or arrays; every leaf
    becomes an fp32 CPU tensor, the master.  step() takes grads of the
    same tree (or a leaf list in the tree's order, consumed as the JAX
    class consumes it) and can return the new parameters as a bf16 tree.
    `state_dict` is the JAX class's layout: {"step", "exp_avg": {"0": ...},
    "exp_avg_sq": {...}, "params": tree}, the leaves numbered in JAX's
    order."""

    def __init__(self, params: Any, lr: float = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 adamw_mode: bool = True):
        self.lr = float(lr)
        self.betas = (float(betas[0]), float(betas[1]))
        self.eps = float(eps)
        self.weight_decay = float(weight_decay)
        self.adamw_mode = bool(adamw_mode)
        self.step_count = 0
        leaves, self._rebuild = tree_flatten(params)
        self._p_leaves = [_host_fp32(x) for x in leaves]
        self.exp_avg = [torch.zeros_like(p) for p in self._p_leaves]
        self.exp_avg_sq = [torch.zeros_like(p) for p in self._p_leaves]
        native_lib()  # raises here, not mid-step, when it cannot build

    @property
    def params(self) -> Any:
        return self._rebuild(self._p_leaves)

    def step(self, grads: Any = None, lr: Optional[float] = None,
             emit_bf16: bool = False, *,
             leaf_list: Optional[list] = None) -> Optional[Any]:
        """One update of every leaf; returns the bf16 tree if emit_bf16.
        Pass exactly one of `grads` (a tree like params, never changed)
        or `leaf_list` (the leaves in order; each entry is set to None
        once its leaf is stepped)."""
        if (grads is None) == (leaf_list is None):
            raise ValueError("pass exactly one of grads / leaf_list")
        if lr is not None:
            self.lr = float(lr)
        self.step_count += 1
        g_leaves = (leaf_list if leaf_list is not None
                    else tree_flatten(grads)[0])
        if len(g_leaves) != len(self._p_leaves):
            raise ValueError(f"{len(g_leaves)} grad leaves for "
                             f"{len(self._p_leaves)} parameters")
        out = []
        for i, (p, m, v) in enumerate(zip(self._p_leaves, self.exp_avg,
                                          self.exp_avg_sq)):
            g = _host_fp32(g_leaves[i]) if not (
                isinstance(g_leaves[i], torch.Tensor)
                and g_leaves[i].dtype == torch.float32
                and g_leaves[i].device.type == "cpu"
                and g_leaves[i].is_contiguous()) else g_leaves[i]
            if leaf_list is not None:
                leaf_list[i] = None
            if g.shape != p.shape:
                raise ValueError(f"grad shape {tuple(g.shape)} != param "
                                 f"shape {tuple(p.shape)}")
            bf16 = torch.empty(p.shape, dtype=torch.bfloat16) \
                if emit_bf16 else None
            adam_step_buffers(p, m, v, g, lr=self.lr, beta1=self.betas[0],
                              beta2=self.betas[1], eps=self.eps,
                              weight_decay=self.weight_decay,
                              step=self.step_count,
                              adamw_mode=self.adamw_mode, bf16_out=bf16)
            out.append(bf16)
        return self._rebuild(out) if emit_bf16 else None

    def state_dict(self) -> Dict[str, Any]:
        return {"step": self.step_count,
                "exp_avg": {str(i): m for i, m in enumerate(self.exp_avg)},
                "exp_avg_sq": {str(i): v
                               for i, v in enumerate(self.exp_avg_sq)},
                "params": self.params}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.step_count = int(np.asarray(sd["step"]))
        for i, (m, v) in enumerate(zip(self.exp_avg, self.exp_avg_sq)):
            m.copy_(_host_fp32(sd["exp_avg"][str(i)]).reshape(m.shape))
            v.copy_(_host_fp32(sd["exp_avg_sq"][str(i)]).reshape(v.shape))
        for dst, src in zip(self._p_leaves, tree_flatten(sd["params"])[0]):
            dst.copy_(_host_fp32(src).reshape(dst.shape))
