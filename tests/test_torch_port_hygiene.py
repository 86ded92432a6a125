"""Static rules of the PyTorch port: deepspeed_tpu_torch/, chip_smoke.py
and flash_ab.py import nothing of JAX or of the JAX package (checked on
the source, since a runtime `sys.modules` check can be fooled by a
pre-imported jax), and
every hand-written kernel has a plain twin, a launch counter and a note
naming the TPU kernel it replaces."""

import ast
import os
from pathlib import Path

import pytest

from deepspeed_tpu_torch.ops import KERNELS, launch_counts, reset_launch_counts

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "deepspeed_tpu_torch"
BANNED = ("jax", "jaxlib", "deepspeed_tpu")


def _port_sources():
    files = sorted(p for p in PORT.rglob("*.py") if "__pycache__" not in p.parts)
    return files + [REPO / "chip_smoke.py", REPO / "flash_ab.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def _banned(module):
    return any(module == b or module.startswith(b + ".") for b in BANNED)


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = _port_sources()
    assert len(files) > 10 and (REPO / "chip_smoke.py").exists()
    found = [f"{p.relative_to(REPO)}:{line} imports {mod}"
             for p in files for line, mod in _imported_modules(p)
             if _banned(mod)]
    assert not found, found


def test_banned_prefix_rule():
    assert _banned("jax.numpy") and _banned("deepspeed_tpu")
    assert _banned("deepspeed_tpu.ops.quant")
    assert not _banned("deepspeed_tpu_torch.ops") and not _banned("jaxtyping")


@pytest.mark.parametrize("kernel", KERNELS, ids=lambda k: k.name)
def test_kernel_has_twin_counter_source_and_tpu_reference(kernel):
    assert isinstance(kernel.wrapper.launches, int)
    assert callable(kernel.plain) and kernel.plain is not kernel.wrapper
    src = REPO / kernel.source
    assert src.exists() and src.suffix == ".cu"
    text = src.read_text()
    jax_file, line = kernel.replaces.rsplit(":", 1)
    # the note in the source names the TPU function it replaces ...
    jax_lines = (REPO / jax_file).read_text().splitlines()
    decl = jax_lines[int(line) - 1]
    assert decl.startswith("def "), decl
    fn_name = decl[4:].split("(")[0]
    assert "Replaces:" in text and fn_name in text, (kernel.source, fn_name)
    # ... and that function's body (up to the next top-level def) reaches
    # pl.pallas_call
    body = []
    for text_line in jax_lines[int(line):]:
        if text_line.startswith("def "):
            break
        body.append(text_line)
    assert "pl.pallas_call(" in "\n".join(body)
    assert "Bound on the H100" in text


def test_every_cuda_source_is_listed():
    listed = {os.path.basename(k.source) for k in KERNELS}
    on_disk = {p.name for p in (PORT / "csrc").glob("*.cu")}
    assert on_disk - listed == {"errors.cu"}


def test_launch_counts_reset():
    reset_launch_counts()
    assert launch_counts() == {k.name: 0 for k in KERNELS}


# the offload tier's modules (ROADMAP.md A.7): host code, no kernel
OFFLOAD_MODULES = ("ops/adam/cpu_adam.py", "runtime/zero/offload.py",
                   "runtime/zero/infinity.py", "runtime/swap_tensor/utils.py",
                   "runtime/swap_tensor/aio_handle.py",
                   "runtime/swap_tensor/async_swapper.py",
                   "runtime/swap_tensor/optimizer_swapper.py",
                   "runtime/swap_tensor/partitioned_param_swapper.py",
                   "utils/tree.py")


@pytest.mark.parametrize("module", OFFLOAD_MODULES)
def test_offload_module_imports_no_jax(module):
    path = PORT / module
    assert path.exists(), module
    found = [f"{module}:{line} imports {mod}"
             for line, mod in _imported_modules(path) if _banned(mod)]
    assert not found, found


def test_host_builders_stay_in_the_port_tree():
    """The host libraries compile the port's own copies
    (deepspeed_tpu_torch/csrc/host/) into the repository's build/, and
    name no file of the JAX package's csrc/."""
    from deepspeed_tpu_torch.ops.op_builder import (AsyncIOBuilder,
                                                    CPUAdamBuilder)
    host = (PORT / "csrc" / "host").resolve()
    for builder in (CPUAdamBuilder(), AsyncIOBuilder()):
        for f in builder.sources() + builder.headers():
            assert Path(f).resolve().parent == host, f
        lib = Path(builder.lib_path()).resolve()
        assert lib.parent == (REPO / "build" / "torch_host").resolve()
    text = (PORT / "ops" / "op_builder.py").read_text()
    assert "csrc/adam" not in text and "csrc/aio" not in text


# the rest of ZeRO-3 (ROADMAP.md A.5b): the sharded layout, the stream's
# per-layer recompute, TiledLinear; plain PyTorch, no kernel
ZERO3_MODULES = ("runtime/sharded_checkpoint.py",
                 "runtime/zero/stage3_streaming.py",
                 "runtime/zero/tiling.py")


@pytest.mark.parametrize("module", ZERO3_MODULES)
def test_zero3_module_imports_no_jax(module):
    path = PORT / module
    assert path.exists(), module
    found = [f"{module}:{line} imports {mod}"
             for line, mod in _imported_modules(path)
             if _banned(mod) or mod.split(".")[0] == "ml_dtypes"]
    assert not found, found
