"""Seconds of PyTorch's SDPA forward and backward at its first and second
call on a shape, by backend (the default, flash, efficient, cuDNN), bf16,
causal, dropout 0.1, with the device kernels each ran; and one masked
call.  On the H100 the default is cuDNN, whose first call at a shape
builds its graph; chip_smoke.py therefore makes its parity cases' graphs
during the kernels' build.  The backends after the default meet graphs
it already built.  Also the seconds of `python -c` that imports torch and
touches the card (a process's start-up).  Prints one JSON object.

    python3 sdpa_first_call.py"""

import json
import subprocess
import sys
import time

import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.nn.attention import SDPBackend, sdpa_kernel
from torch.profiler import ProfilerActivity, profile

SHAPES = ((2, 4, 200, 136), (2, 4, 200, 256), (2, 8, 200, 128),
          (2, 12, 77, 64))


def seconds(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def kernels(fn):
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.name[:70] for e in prof.events()
                   if e.device_type == DeviceType.CUDA})


def inputs(b, h, s, d):
    g = torch.Generator(device="cuda").manual_seed(s + d)
    return [torch.randn(b, h, s, d, device="cuda", generator=g,
                        dtype=torch.bfloat16).requires_grad_()
            for _ in range(3)]


def main():
    out = {}
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c", "import torch; "
                    "torch.zeros(1, device='cuda')"], check=True)
    out["python_import_torch_cuda_s"] = time.perf_counter() - t0
    for label, backend in (
            ("default", None), ("flash", SDPBackend.FLASH_ATTENTION),
            ("efficient", SDPBackend.EFFICIENT_ATTENTION),
            ("cudnn", getattr(SDPBackend, "CUDNN_ATTENTION", None))):
        rows = {}
        for shape in SHAPES:
            q, k, v = inputs(*shape)

            def fwd():
                if backend is None:
                    return F.scaled_dot_product_attention(
                        q, k, v, is_causal=True, dropout_p=0.1)
                with sdpa_kernel(backend):
                    return F.scaled_dot_product_attention(
                        q, k, v, is_causal=True, dropout_p=0.1)
            try:
                row = {"fwd_first_s": seconds(fwd),
                       "fwd_second_s": seconds(fwd)}
                o = fwd()

                def bwd():
                    torch.autograd.grad(o, (q, k, v), torch.ones_like(o),
                                        retain_graph=True)
                row.update(bwd_first_s=seconds(bwd),
                           bwd_second_s=seconds(bwd), kernels=kernels(fwd))
            except RuntimeError as exc:
                row = {"error": str(exc)[:200]}
            rows[str(shape)] = row
        out[label] = rows
    q, k, v = inputs(2, 4, 1024, 136)
    mask = torch.ones(1024, 1024, dtype=torch.bool, device="cuda").tril()

    def masked():
        F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    out["masked_default"] = {"fwd_first_s": seconds(masked),
                             "fwd_second_s": seconds(masked),
                             "kernels": kernels(masked)}
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
