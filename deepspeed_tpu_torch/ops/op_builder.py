"""Builds the port's CUDA kernels (counterpart of deepspeed_tpu/ops/op_builder.py).

Every `deepspeed_tpu_torch/csrc/*.cu` is compiled by `nvcc` for Hopper
(`sm_90a`) into ONE shared library with a plain C interface, which is
loaded with `ctypes`.  No PyTorch header is included, so a build takes
seconds, not minutes.  The sources compile in parallel (one `nvcc` per
file) and link into `build/torch_kernels/libds_torch_kernels-<hash>.so`,
where the hash covers the sources and the flags: a changed source builds
anew and an unchanged one loads the library already built.

The build happens at first use, inside the process that launches a
kernel, never at import.  A failed build raises with nvcc's stderr.

The offload tier's host libraries are built here too (`CPUAdamBuilder`,
`AsyncIOBuilder`, the counterparts of the JAX package's builders): C++
for the CPU in `deepspeed_tpu_torch/csrc/host/`, compiled by `g++ -O3
-march=native -pthread` into `build/torch_host/<name>-<hash>.so` at first
use and loaded with `ctypes`.  Where the JAX package links OpenMP, the
port's copies run std::threads: the toolchain beside the GPU need not
ship libgomp.  They read no file outside the port's tree, and a
failed build raises with g++'s stderr.
"""

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import time
from typing import Dict, List, Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
HOST_CSRC_DIR = os.path.join(CSRC_DIR, "host")
HOST_BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_host")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]
LIB_NAME = "libds_torch_kernels"

P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_int64
F32 = ctypes.c_float
I64_PTR = ctypes.POINTER(ctypes.c_int64)

# C signature of every exported launcher: (argtypes); each returns the
# cudaError_t of its launch as an int.  A pointer or the stream passed
# without c_void_p would be cut to 32 bits.
SIGNATURES = {
    # x, gamma, beta, out, eps, the launch (int32[8]: rows, hidden, x's and
    # gamma's dtype codes (gamma's may be fp16), then ops/normalize.py layer_norm_plan's route,
    # threads a row, rows a block, blocks), stream
    "ds_layer_norm_fwd": [P, P, P, P, F32, P, P],
    # x, gamma, dy, dx, the fp32 workspace [blocks, 2, hidden], dgamma,
    # dbeta, eps, the launch as the forward's, stream
    "ds_layer_norm_bwd": [P] * 7 + [F32, P, P],
    # rows, hidden, dtype, aligned, backward, plan (int32[6] out: route,
    # threads a row, packs a thread, slots, rows a slot, blocks); launches
    # nothing
    "ds_layer_norm_plan": [I32] * 5 + [P],
    # q, k, v, out, lse, B, H, Sq, Sk, D, chunks (flash_attention.py
    # head_dim_plan), q/k/v/out strides (batch, head, seq), sm_scale,
    # causal, seed (device int32), keep threshold, keep scale, dtype, stream
    "ds_flash_attention_fwd": [P, P, P, P, P] + [I32] * 6
                              + [I64] * 12 + [F32, I32, P, I32, F32, I32, P],
    # q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Sk, D, chunks, the 18
    # strides of q/k/v/dout/dk/dv, sm_scale, causal, seed, keep threshold,
    # keep scale, dtype, stream
    "ds_flash_attention_bwd_dkdv": [P] * 8 + [I32] * 6
                                   + [I64_PTR, F32, I32, P, I32, F32, I32, P],
    # q, k, v, dout, lse, delta, dq, B, H, Sq, Sk, D, chunks, the 15
    # strides of q/k/v/dout/dq, then as dkdv
    "ds_flash_attention_bwd_dq": [P] * 7 + [I32] * 6
                                 + [I64_PTR, F32, I32, P, I32, F32, I32, P],
    # q, k, v, out, lse, idx, valid, B, H, S, D, chunks, block, max_deg, the
    # 12 strides of q/k/v/out, sm_scale, causal, dtype, stream
    "ds_block_sparse_flash_fwd": [P] * 7 + [I32] * 7
                                 + [I64_PTR, F32, I32, I32, P],
    # q, k, v, dout, lse, delta, dq, idx, valid, B, H, S, D, chunks, block,
    # max_deg, the 15 strides of q/k/v/dout/dq, sm_scale, causal, dtype,
    # stream
    "ds_block_sparse_flash_bwd_dq": [P] * 9 + [I32] * 7
                                    + [I64_PTR, F32, I32, I32, P],
    # q, k, v, dout, lse, delta, dk, dv, idx_t, valid_t, B, H, S, D, chunks,
    # block, max_deg_t, the 18 strides of q/k/v/dout/dk/dv, then as dq
    "ds_block_sparse_flash_bwd_dkdv": [P] * 10 + [I32] * 7
                                      + [I64_PTR, F32, I32, I32, P],
    # x, qweight, scale, out, M, K, N, groups, dtype, stream
    "ds_dequant_matmul": [P, P, P, P, I32, I32, I32, I32, I32, P],
    # x, qweight, M, K, N, dtype -> which kernel the launcher takes
    # (0 gemv, 1 mma, 2 tiled, 3 gemv_mma); launches nothing
    "ds_dequant_matmul_route": [P, P, I32, I32, I32, I32],
    # x, qweight, M, K, N, dtype, plan (int32[5] out: route, columns a
    # block, GEMV split and threads, blocks; ops/quant.py dequant_plan);
    # launches nothing
    "ds_dequant_matmul_plan": [P, P, I32, I32, I32, I32, P],
    # kernel H.  x (or g), its row pitch, its dtype; the weight payload, its
    # scales, layout (0 native, 1 int8, 2 packed int4), native dtype, block
    # size; out (fp32), m, kc, n; for ag_t the split partials' workspace (or
    # null) and the number of splits (bf16 g only); stream
    "ds_fcm_tile_ag": [P, I64, I32, P, P, I32, I32, I32, P, I32, I32, I32, P],
    "ds_fcm_tile_ag_t": [P, I64, I32, P, P, I32, I32, I32, P, I32, I32, I32,
                         P, I32, P],
    # a, pitch, dtype, b, pitch, dtype, out (fp32), rows of a and b, kc, n,
    # the split partials' workspace (or null) and the number of splits (bf16
    # a and b only), stream
    "ds_fcm_tile_rs": [P, I64, I32, P, I64, I32, P, I32, I32, I32, P, I32, P],
    # kernel I.  x and the weight as kernel H; the fp32 accumulator, out (or
    # null), out's dtype, whether the accumulator is read; m, kc, n, stream
    "ds_fcm_ag_step": [P, I64, I32, P, P, I32, I32, I32, P, P, I32, I32, I32,
                       I32, I32, P],
    # g and the weight as kernel H; out's column block, out's row pitch and
    # dtype; m, kc, n; the split partials' workspace (or null) and the
    # number of splits (bf16 g only); stream
    "ds_fcm_ag_step_t": [P, I64, I32, P, P, I32, I32, I32, P, I64, I32, I32,
                         I32, I32, P, I32, P],
    # kernel J.  a, pitch, dtype, b, pitch, dtype, error rows (or null), q,
    # scale, new error (or null), compensated tile (or null), rows of a and
    # b, kc, n, block size, whether the epilogue quantizes, the split
    # partials' workspace and the number of splits (bf16 a and b only),
    # stream
    "ds_fcm_rs_producer": [P, I64, I32, P, I64, I32, P, P, P, P, P, I32, I32,
                           I32, I32, I32, P, I32, P],
    # compensated tile, q, scale, new error (or null), elements, block size,
    # stream
    "ds_fcm_rs_quantize": [P, P, P, P, I64, I32, P],
    # q table, scale table, out (fp32), sources, elements per tile, block
    # size, stream
    "ds_fcm_rs_collect": [P, P, P, I32, I64, I32, P],
    # q table, out, sources, elements per tile, block size, plan (int32[4]
    # out: elements a chunk, threads a block, blocks, unrolled sources or 0;
    # ops/collective_matmul.py collect_plan); launches nothing
    "ds_fcm_rs_collect_plan": [P, P, I32, I64, I32, P],
}

# dtype codes shared with csrc/common.cuh (fp16: kernels A's and D's gamma
# and beta only)
DTYPE_FP32 = 0
DTYPE_BF16 = 1
DTYPE_FP16 = 2

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None


def sources():
    return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       f"{home}/bin): the CUDA kernels cannot be built")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _run_all(cmds):
    """Start every command at once, wait for all, raise on the first
    failure with its stderr."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    failures = []
    for cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"$ {' '.join(cmd)}\n{err}")
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))


def build() -> str:
    """Compile the library if this source hash has none yet; return its
    path."""
    global build_seconds
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, f"{LIB_NAME}-{_source_hash()}.so")
    if os.path.exists(lib_path):
        build_seconds = 0.0
        return lib_path
    t0 = time.perf_counter()
    nvcc = _nvcc()
    cu_files = [s for s in sources() if s.endswith(".cu")]
    objs = []
    cmds = []
    for src in cu_files:
        obj = os.path.join(BUILD_DIR, os.path.basename(src) + f".{os.getpid()}.o")
        objs.append(obj)
        cmds.append([nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-c", src, "-o", obj])
    _run_all(cmds)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    _run_all([[nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", tmp]])
    os.replace(tmp, lib_path)
    for obj in objs:
        os.remove(obj)
    build_seconds = time.perf_counter() - t0
    return lib_path


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed (once per
    process)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.ds_error_string.argtypes = [I32]
        lib.ds_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check_launch(name: str, err: int) -> None:
    """Raise when a launcher reports a CUDA error (a refused launch never
    runs, and a later synchronize would not say so)."""
    if err != 0:
        msg = load().ds_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: error {err} "
                           f"({msg})")


# --------------------------------------------------------------------- #
# the offload tier's host libraries (g++, loaded with ctypes)
# --------------------------------------------------------------------- #
def _cpu_identity() -> str:
    """The CPU model and ISA flags that -march=native binds the library
    to: part of the build's key, so a library built on another host is
    never loaded."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "flags", "Features")):
                    return line.strip()
    except OSError:
        pass
    return platform.processor() or "unknown-cpu"


class HostOpBuilder:
    """Compile-and-load of one host library (the JAX package's OpBuilder):
    `sources()` under csrc/host/, `headers()` that key the build without
    being compiled, `ldflags()`.  `load()` returns the ctypes.CDLL, built
    first when this hash has none."""

    NAME = "base"
    _cache: Dict[str, ctypes.CDLL] = {}

    def sources(self) -> List[str]:
        raise NotImplementedError

    def headers(self) -> List[str]:
        return []

    def cxx_flags(self) -> List[str]:
        return ["-O3", "-std=c++17", "-fPIC", "-shared", "-march=native",
                "-pthread"]

    def ldflags(self) -> List[str]:
        return []

    @staticmethod
    def compiler() -> str:
        return os.environ.get("CXX", "g++")

    def _hash(self) -> str:
        h = hashlib.sha256()
        for path in self.sources() + self.headers():
            with open(path, "rb") as f:
                h.update(f.read())
        h.update(" ".join(self.cxx_flags() + self.ldflags()).encode())
        h.update(platform.machine().encode())
        h.update(_cpu_identity().encode())
        return h.hexdigest()[:16]

    def lib_path(self) -> str:
        return os.path.join(HOST_BUILD_DIR, f"{self.NAME}-{self._hash()}.so")

    def build(self) -> str:
        path = self.lib_path()
        if os.path.exists(path):
            return path
        os.makedirs(HOST_BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = ([self.compiler()] + self.cxx_flags() + self.sources()
               + self.ldflags() + ["-o", tmp])
        try:
            subprocess.run(cmd, capture_output=True, check=True, text=True)
        except (OSError, subprocess.CalledProcessError) as e:
            err = getattr(e, "stderr", None) or str(e)
            raise RuntimeError(f"host library {self.NAME} failed to build:\n"
                               f"$ {' '.join(cmd)}\n{err}") from e
        os.replace(tmp, path)  # atomic against a concurrent builder
        return path

    def load(self) -> ctypes.CDLL:
        key = self.lib_path()
        if key not in HostOpBuilder._cache:
            HostOpBuilder._cache[key] = ctypes.CDLL(self.build())
        return HostOpBuilder._cache[key]


class CPUAdamBuilder(HostOpBuilder):
    """The host Adam / AdamW of the offload tier (csrc/host/host_adam.cpp)."""

    NAME = "cpu_adam"

    def sources(self):
        return [os.path.join(HOST_CSRC_DIR, "host_adam.cpp")]


class AsyncIOBuilder(HostOpBuilder):
    """The async file I/O engines of the NVMe tier: the thread-pool and
    batched engines (csrc/host/host_aio.cpp) and the io_uring engine
    (uring_aio.cpp), which is compiled everywhere and probed at run time."""

    NAME = "async_io"

    def sources(self):
        return [os.path.join(HOST_CSRC_DIR, "host_aio.cpp"),
                os.path.join(HOST_CSRC_DIR, "uring_aio.cpp")]

    def headers(self):
        return [os.path.join(HOST_CSRC_DIR, "aio_backend.h")]

    def ldflags(self):
        return ["-lpthread"]
