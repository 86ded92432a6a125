"""DeepSpeed-compatible JSON config → typed config objects.

A copy of deepspeed_tpu/config.py, the same schema, defaults, batch-triple
inference and errors.  The port keeps its own copy (ROADMAP.md A.2): the JAX package's module
is jax-free, but importing it runs deepspeed_tpu/__init__.py, which
imports JAX.  What the copy cannot reach is
marked where it stands: the chaos fault catalog (resilience.chaos,
ROADMAP.md A.13), which `initialize` refuses anyway.

Reference: deepspeed/runtime/config.py:682 (DeepSpeedConfig), including the
train-batch triple inference (config.py:869-924) and duplicate-key rejection
(config.py:688-691).  The schema is the reference's; the backing runtime is
TPU-native (JAX meshes instead of NCCL process groups).
"""

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from . import constants as C
from .config_utils import get_scalar_param, load_config_dict


class DeepSpeedConfigError(Exception):
    pass


@dataclass
class FP16Config:
    enabled: bool = C.FP16_ENABLED_DEFAULT
    loss_scale: float = C.FP16_LOSS_SCALE_DEFAULT
    initial_scale_power: int = C.FP16_INITIAL_SCALE_POWER_DEFAULT
    loss_scale_window: int = C.FP16_LOSS_SCALE_WINDOW_DEFAULT
    hysteresis: int = C.FP16_HYSTERESIS_DEFAULT
    min_loss_scale: float = C.FP16_MIN_LOSS_SCALE_DEFAULT
    fp16_master_weights_and_grads: bool = C.FP16_MASTER_WEIGHTS_AND_GRADS_DEFAULT

    @property
    def dynamic_loss_scale(self) -> bool:
        return self.loss_scale == 0

    @staticmethod
    def from_dict(d: Optional[Dict[str, Any]]) -> "FP16Config":
        d = d or {}
        return FP16Config(
            enabled=get_scalar_param(d, C.FP16_ENABLED, C.FP16_ENABLED_DEFAULT),
            loss_scale=get_scalar_param(d, C.FP16_LOSS_SCALE,
                                        C.FP16_LOSS_SCALE_DEFAULT),
            initial_scale_power=get_scalar_param(
                d, C.FP16_INITIAL_SCALE_POWER, C.FP16_INITIAL_SCALE_POWER_DEFAULT),
            loss_scale_window=get_scalar_param(d, C.FP16_LOSS_SCALE_WINDOW,
                                               C.FP16_LOSS_SCALE_WINDOW_DEFAULT),
            hysteresis=get_scalar_param(d, C.FP16_HYSTERESIS,
                                        C.FP16_HYSTERESIS_DEFAULT),
            min_loss_scale=get_scalar_param(d, C.FP16_MIN_LOSS_SCALE,
                                            C.FP16_MIN_LOSS_SCALE_DEFAULT),
            fp16_master_weights_and_grads=get_scalar_param(
                d, C.FP16_MASTER_WEIGHTS_AND_GRADS,
                C.FP16_MASTER_WEIGHTS_AND_GRADS_DEFAULT),
        )


@dataclass
class BF16Config:
    """TPU-native: bf16 is the preferred training dtype on TPU (MXU-native,
    no loss scaling required)."""
    enabled: bool = C.BF16_ENABLED_DEFAULT
    # bf16 gradient buffers (reference analog: fp16 grads under ZeRO
    # stage 1/2 — deepspeed/runtime/zero/stage2.py keeps fp16 grad
    # buffers and the fp32 upcast happens in the optimizer).  Halves
    # grad HBM + stage-2 reduce-scatter width; micro-batch accumulation
    # rounds through bf16 like the reference's fp16 accumulation.
    grads_in_compute_dtype: bool = C.BF16_GRADS_IN_COMPUTE_DTYPE_DEFAULT

    @staticmethod
    def from_dict(d: Optional[Dict[str, Any]]) -> "BF16Config":
        d = d or {}
        return BF16Config(
            enabled=get_scalar_param(d, C.BF16_ENABLED,
                                     C.BF16_ENABLED_DEFAULT),
            grads_in_compute_dtype=get_scalar_param(
                d, C.BF16_GRADS_IN_COMPUTE_DTYPE,
                C.BF16_GRADS_IN_COMPUTE_DTYPE_DEFAULT))


@dataclass
class OffloadParamConfig:
    device: str = C.OFFLOAD_PARAM_DEVICE_DEFAULT
    nvme_path: Optional[str] = C.OFFLOAD_PARAM_NVME_PATH_DEFAULT
    buffer_count: int = C.OFFLOAD_PARAM_BUFFER_COUNT_DEFAULT
    buffer_size: int = C.OFFLOAD_PARAM_BUFFER_SIZE_DEFAULT
    max_in_cpu: int = C.OFFLOAD_PARAM_MAX_IN_CPU_DEFAULT
    pin_memory: bool = C.OFFLOAD_PARAM_PIN_MEMORY_DEFAULT
    prefetch_depth: int = C.OFFLOAD_PARAM_PREFETCH_DEPTH_DEFAULT

    @staticmethod
    def from_dict(d: Optional[Dict[str, Any]]) -> Optional["OffloadParamConfig"]:
        if d is None:
            return None
        buffer_count = int(get_scalar_param(
            d, C.OFFLOAD_PARAM_BUFFER_COUNT,
            C.OFFLOAD_PARAM_BUFFER_COUNT_DEFAULT))
        prefetch_depth = int(get_scalar_param(
            d, C.OFFLOAD_PARAM_PREFETCH_DEPTH,
            C.OFFLOAD_PARAM_PREFETCH_DEPTH_DEFAULT))
        if prefetch_depth < 0:
            raise DeepSpeedConfigError(
                f"offload_param.{C.OFFLOAD_PARAM_PREFETCH_DEPTH}="
                f"{prefetch_depth} — must be >= 0 (< 2 disables NVMe "
                "prefetch, 2 is the double buffer)")
        # the streaming window clamps to >= 2 slots (infinity.py), so the
        # depth bound checks against the same clamp
        if prefetch_depth > max(2, buffer_count):
            raise DeepSpeedConfigError(
                f"offload_param.{C.OFFLOAD_PARAM_PREFETCH_DEPTH}="
                f"{prefetch_depth} exceeds "
                f"{C.OFFLOAD_PARAM_BUFFER_COUNT}={buffer_count} — every "
                "in-flight swap-in pins one window buffer; raise "
                "buffer_count or lower the depth")
        return OffloadParamConfig(
            device=get_scalar_param(d, C.OFFLOAD_PARAM_DEVICE,
                                    C.OFFLOAD_PARAM_DEVICE_DEFAULT),
            nvme_path=get_scalar_param(d, C.OFFLOAD_PARAM_NVME_PATH,
                                       C.OFFLOAD_PARAM_NVME_PATH_DEFAULT),
            buffer_count=buffer_count,
            buffer_size=int(get_scalar_param(d, C.OFFLOAD_PARAM_BUFFER_SIZE,
                                             C.OFFLOAD_PARAM_BUFFER_SIZE_DEFAULT)),
            max_in_cpu=int(get_scalar_param(d, C.OFFLOAD_PARAM_MAX_IN_CPU,
                                            C.OFFLOAD_PARAM_MAX_IN_CPU_DEFAULT)),
            pin_memory=get_scalar_param(d, C.OFFLOAD_PARAM_PIN_MEMORY,
                                        C.OFFLOAD_PARAM_PIN_MEMORY_DEFAULT),
            prefetch_depth=prefetch_depth,
        )


@dataclass
class OffloadOptimizerConfig:
    device: str = C.OFFLOAD_OPTIMIZER_DEVICE_DEFAULT
    nvme_path: Optional[str] = C.OFFLOAD_OPTIMIZER_NVME_PATH_DEFAULT
    buffer_count: int = C.OFFLOAD_OPTIMIZER_BUFFER_COUNT_DEFAULT
    pin_memory: bool = C.OFFLOAD_OPTIMIZER_PIN_MEMORY_DEFAULT
    pipeline_read: bool = C.OFFLOAD_OPTIMIZER_PIPELINE_READ_DEFAULT
    pipeline_write: bool = C.OFFLOAD_OPTIMIZER_PIPELINE_WRITE_DEFAULT
    fast_init: bool = C.OFFLOAD_OPTIMIZER_FAST_INIT_DEFAULT
    pipeline_depth: int = C.OFFLOAD_OPTIMIZER_PIPELINE_DEPTH_DEFAULT

    @property
    def pipeline(self) -> bool:
        return self.pipeline_read or self.pipeline_write

    @staticmethod
    def from_dict(d: Optional[Dict[str, Any]]) -> Optional["OffloadOptimizerConfig"]:
        if d is None:
            return None
        pipeline_depth = int(get_scalar_param(
            d, C.OFFLOAD_OPTIMIZER_PIPELINE_DEPTH,
            C.OFFLOAD_OPTIMIZER_PIPELINE_DEPTH_DEFAULT))
        if pipeline_depth < 2:
            raise DeepSpeedConfigError(
                f"offload_optimizer.{C.OFFLOAD_OPTIMIZER_PIPELINE_DEPTH}="
                f"{pipeline_depth} — the leaf sweep needs >= 2 rotating "
                "buffer triples to overlap reads/Adam/write-backs "
                "(reference PipelinedOptimizerSwapper is depth 2)")
        return OffloadOptimizerConfig(
            device=get_scalar_param(d, C.OFFLOAD_OPTIMIZER_DEVICE,
                                    C.OFFLOAD_OPTIMIZER_DEVICE_DEFAULT),
            nvme_path=get_scalar_param(d, C.OFFLOAD_OPTIMIZER_NVME_PATH,
                                       C.OFFLOAD_OPTIMIZER_NVME_PATH_DEFAULT),
            buffer_count=int(get_scalar_param(
                d, C.OFFLOAD_OPTIMIZER_BUFFER_COUNT,
                C.OFFLOAD_OPTIMIZER_BUFFER_COUNT_DEFAULT)),
            pin_memory=get_scalar_param(d, C.OFFLOAD_OPTIMIZER_PIN_MEMORY,
                                        C.OFFLOAD_OPTIMIZER_PIN_MEMORY_DEFAULT),
            pipeline_read=get_scalar_param(
                d, C.OFFLOAD_OPTIMIZER_PIPELINE_READ,
                C.OFFLOAD_OPTIMIZER_PIPELINE_READ_DEFAULT),
            pipeline_write=get_scalar_param(
                d, C.OFFLOAD_OPTIMIZER_PIPELINE_WRITE,
                C.OFFLOAD_OPTIMIZER_PIPELINE_WRITE_DEFAULT),
            fast_init=get_scalar_param(d, C.OFFLOAD_OPTIMIZER_FAST_INIT,
                                       C.OFFLOAD_OPTIMIZER_FAST_INIT_DEFAULT),
            pipeline_depth=pipeline_depth,
        )


@dataclass
class ZeroLowBandwidthConfig:
    """ZeRO++-style low-bandwidth collectives (arXiv:2306.10209).

    qwz_bits: blockwise-quantized weight all-gather width (0=off, 4, 8).
    qgz_bits: quantized gradient reduce-scatter width (0=off, 4, 8) —
        int4 rides the wire packed two-per-byte.
    hpz_group_size: size of the sub-mesh holding the secondary weight
        partition (0/1 = off); must equal the product of a suffix of the
        ZeRO mesh axes (partition.resolve_hpz_axes).
    block_size: elements per quantization block (scale granularity).
    fused_collective_matmul: T3-style per-tile fusion of the qwZ/qgZ
        transports with the producer/consumer GEMM schedule
        (ops/collective_matmul.py): the streamed-ZeRO-3 gathers and
        grad scatters move tile-by-tile over a ring instead of as one
        monolithic collective, and the Schedule Auditor classifies the
        per-tile wire as fused/hidden.  Off by default.
    onebit: 1-bit optimizer wire tier (docs/onebit.md): after the onebit
        optimizer's freeze_step the data-parallel grad allreduce is
        removed from the grad program and replaced by an error-feedback
        sign+scale momentum sync on a packed int8 wire
        (comm/compressed.py wire="packed").  Requires a OneBitAdam /
        OneBitLamb optimizer and ZeRO stage <= 2; hpz_group_size doubles
        as the hierarchical group size (intra-group dense, cross-group
        1-bit).  Off by default.
    """
    qwz_bits: int = C.LOW_BANDWIDTH_QWZ_BITS_DEFAULT
    qgz_bits: int = C.LOW_BANDWIDTH_QGZ_BITS_DEFAULT
    hpz_group_size: int = C.LOW_BANDWIDTH_HPZ_GROUP_SIZE_DEFAULT
    block_size: int = C.LOW_BANDWIDTH_BLOCK_SIZE_DEFAULT
    fused_collective_matmul: bool = C.LOW_BANDWIDTH_FCM_DEFAULT
    onebit: bool = C.LOW_BANDWIDTH_ONEBIT_DEFAULT

    @property
    def enabled(self) -> bool:
        # fused_collective_matmul alone engages the low-bandwidth
        # context: the per-tile ring schedule applies at native width
        # even with both quantizers off.  `onebit` deliberately does NOT
        # feed this property — it is a data-parallel wire feature, not a
        # stage-3 streaming transport, and must not engage the streaming
        # context (or its stage<3 "will be ignored" warning).
        return bool(self.qwz_bits or self.qgz_bits or
                    self.hpz_group_size > 1 or
                    self.fused_collective_matmul)

    @staticmethod
    def from_dict(d: Optional[Dict[str, Any]]) -> "ZeroLowBandwidthConfig":
        d = d or {}
        cfg = ZeroLowBandwidthConfig(
            qwz_bits=int(get_scalar_param(d, C.LOW_BANDWIDTH_QWZ_BITS,
                                          C.LOW_BANDWIDTH_QWZ_BITS_DEFAULT)),
            qgz_bits=int(get_scalar_param(d, C.LOW_BANDWIDTH_QGZ_BITS,
                                          C.LOW_BANDWIDTH_QGZ_BITS_DEFAULT)),
            hpz_group_size=int(get_scalar_param(
                d, C.LOW_BANDWIDTH_HPZ_GROUP_SIZE,
                C.LOW_BANDWIDTH_HPZ_GROUP_SIZE_DEFAULT)),
            block_size=int(get_scalar_param(
                d, C.LOW_BANDWIDTH_BLOCK_SIZE,
                C.LOW_BANDWIDTH_BLOCK_SIZE_DEFAULT)),
            fused_collective_matmul=get_scalar_param(
                d, C.LOW_BANDWIDTH_FCM, C.LOW_BANDWIDTH_FCM_DEFAULT),
            onebit=get_scalar_param(
                d, C.LOW_BANDWIDTH_ONEBIT, C.LOW_BANDWIDTH_ONEBIT_DEFAULT),
        )
        for name, bits in ((C.LOW_BANDWIDTH_QWZ_BITS, cfg.qwz_bits),
                           (C.LOW_BANDWIDTH_QGZ_BITS, cfg.qgz_bits)):
            if bits not in (0, 4, 8):
                raise DeepSpeedConfigError(
                    f"zero_optimization.low_bandwidth.{name}={bits} — "
                    "supported widths are 0 (off), 4, and 8")
        if cfg.block_size < 1:
            raise DeepSpeedConfigError(
                "zero_optimization.low_bandwidth.block_size must be >= 1, "
                f"got {cfg.block_size}")
        if not isinstance(cfg.fused_collective_matmul, bool):
            raise DeepSpeedConfigError(
                f"zero_optimization.low_bandwidth.{C.LOW_BANDWIDTH_FCM} "
                f"must be a bool, got {cfg.fused_collective_matmul!r}")
        if not isinstance(cfg.onebit, bool):
            raise DeepSpeedConfigError(
                f"zero_optimization.low_bandwidth.{C.LOW_BANDWIDTH_ONEBIT} "
                f"must be a bool, got {cfg.onebit!r}")
        return cfg


def _validated_prefetch_mode(mode: str) -> str:
    if mode not in C.ZERO_OPTIMIZATION_PREFETCH_MODES:
        raise DeepSpeedConfigError(
            f"zero_optimization.{C.ZERO_OPTIMIZATION_PREFETCH_MODE}="
            f"{mode!r} — supported modes are "
            f"{list(C.ZERO_OPTIMIZATION_PREFETCH_MODES)}")
    return mode


@dataclass
class ZeroConfig:
    """Reference: deepspeed/runtime/zero/config.py:18 (DeepSpeedZeroConfig)."""
    stage: int = C.ZERO_OPTIMIZATION_STAGE_DEFAULT
    contiguous_gradients: bool = True
    reduce_scatter: bool = C.ZERO_OPTIMIZATION_REDUCE_SCATTER_DEFAULT
    reduce_bucket_size: int = C.ZERO_OPTIMIZATION_REDUCE_BUCKET_SIZE_DEFAULT
    allgather_partitions: bool = C.ZERO_OPTIMIZATION_ALLGATHER_PARTITIONS_DEFAULT
    allgather_bucket_size: int = C.ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE_DEFAULT
    overlap_comm: bool = False
    offload_param: Optional[OffloadParamConfig] = None
    offload_optimizer: Optional[OffloadOptimizerConfig] = None
    sub_group_size: int = C.ZERO_OPTIMIZATION_SUB_GROUP_SIZE_DEFAULT
    max_live_parameters: int = C.ZERO_OPTIMIZATION_MAX_LIVE_PARAMETERS_DEFAULT
    max_reuse_distance: int = C.ZERO_OPTIMIZATION_MAX_REUSE_DISTANCE_DEFAULT
    prefetch_bucket_size: int = C.ZERO_OPTIMIZATION_PREFETCH_BUCKET_SIZE_DEFAULT
    prefetch_mode: str = C.ZERO_OPTIMIZATION_PREFETCH_MODE_DEFAULT
    param_persistence_threshold: int = (
        C.ZERO_OPTIMIZATION_PARAM_PERSISTENCE_THRESHOLD_DEFAULT)
    gather_fp16_weights_on_model_save: bool = (
        C.ZERO_OPTIMIZATION_GATHER_FP16_WEIGHTS_ON_MODEL_SAVE_DEFAULT)
    ignore_unused_parameters: bool = (
        C.ZERO_OPTIMIZATION_IGNORE_UNUSED_PARAMETERS_DEFAULT)
    legacy_stage1: bool = C.ZERO_OPTIMIZATION_LEGACY_STAGE1_DEFAULT
    elastic_checkpoint: bool = C.ZERO_OPTIMIZATION_ELASTIC_CHECKPOINT_DEFAULT
    cpu_offload: bool = C.ZERO_OPTIMIZATION_CPU_OFFLOAD_DEFAULT
    cpu_offload_params: bool = C.ZERO_OPTIMIZATION_CPU_OFFLOAD_PARAMS_DEFAULT
    low_bandwidth: ZeroLowBandwidthConfig = field(
        default_factory=ZeroLowBandwidthConfig)

    @staticmethod
    def from_dict(d: Optional[Dict[str, Any]]) -> "ZeroConfig":
        if d is None:
            d = {}
        if isinstance(d, bool):  # "zero_optimization": true → stage 1
            d = {C.ZERO_OPTIMIZATION_STAGE: 1 if d else 0}
        stage = get_scalar_param(d, C.ZERO_OPTIMIZATION_STAGE,
                                 C.ZERO_OPTIMIZATION_STAGE_DEFAULT)
        # Legacy cpu_offload flags map onto the offload_* sub-dicts
        # (reference: zero/config.py offload back-compat).
        cpu_offload = get_scalar_param(d, C.ZERO_OPTIMIZATION_CPU_OFFLOAD,
                                       C.ZERO_OPTIMIZATION_CPU_OFFLOAD_DEFAULT)
        cpu_offload_params = get_scalar_param(
            d, C.ZERO_OPTIMIZATION_CPU_OFFLOAD_PARAMS,
            C.ZERO_OPTIMIZATION_CPU_OFFLOAD_PARAMS_DEFAULT)
        cpu_offload_pin = get_scalar_param(
            d, C.ZERO_OPTIMIZATION_CPU_OFFLOAD_USE_PIN_MEMORY,
            C.ZERO_OPTIMIZATION_CPU_OFFLOAD_USE_PIN_MEMORY_DEFAULT)
        offload_param = OffloadParamConfig.from_dict(
            d.get(C.ZERO_OPTIMIZATION_OFFLOAD_PARAM))
        offload_optimizer = OffloadOptimizerConfig.from_dict(
            d.get(C.ZERO_OPTIMIZATION_OFFLOAD_OPTIMIZER))
        if cpu_offload and offload_optimizer is None:
            offload_optimizer = OffloadOptimizerConfig(
                device=C.OFFLOAD_CPU_DEVICE, pin_memory=cpu_offload_pin)
        if cpu_offload_params and offload_param is None:
            offload_param = OffloadParamConfig(
                device=C.OFFLOAD_CPU_DEVICE, pin_memory=cpu_offload_pin)
        overlap_default = stage == C.ZERO_OPTIMIZATION_WEIGHTS
        contiguous_default = True
        return ZeroConfig(
            stage=stage,
            contiguous_gradients=get_scalar_param(
                d, C.ZERO_OPTIMIZATION_CONTIGUOUS_GRADIENTS, contiguous_default),
            reduce_scatter=get_scalar_param(
                d, C.ZERO_OPTIMIZATION_REDUCE_SCATTER,
                C.ZERO_OPTIMIZATION_REDUCE_SCATTER_DEFAULT),
            reduce_bucket_size=int(get_scalar_param(
                d, C.ZERO_OPTIMIZATION_REDUCE_BUCKET_SIZE,
                C.ZERO_OPTIMIZATION_REDUCE_BUCKET_SIZE_DEFAULT)),
            allgather_partitions=get_scalar_param(
                d, C.ZERO_OPTIMIZATION_ALLGATHER_PARTITIONS,
                C.ZERO_OPTIMIZATION_ALLGATHER_PARTITIONS_DEFAULT),
            allgather_bucket_size=int(get_scalar_param(
                d, C.ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE,
                C.ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE_DEFAULT)),
            overlap_comm=get_scalar_param(d, C.ZERO_OPTIMIZATION_OVERLAP_COMM,
                                          overlap_default),
            offload_param=offload_param,
            offload_optimizer=offload_optimizer,
            sub_group_size=int(get_scalar_param(
                d, C.ZERO_OPTIMIZATION_SUB_GROUP_SIZE,
                C.ZERO_OPTIMIZATION_SUB_GROUP_SIZE_DEFAULT)),
            max_live_parameters=int(get_scalar_param(
                d, C.ZERO_OPTIMIZATION_MAX_LIVE_PARAMETERS,
                C.ZERO_OPTIMIZATION_MAX_LIVE_PARAMETERS_DEFAULT)),
            max_reuse_distance=int(get_scalar_param(
                d, C.ZERO_OPTIMIZATION_MAX_REUSE_DISTANCE,
                C.ZERO_OPTIMIZATION_MAX_REUSE_DISTANCE_DEFAULT)),
            prefetch_bucket_size=int(get_scalar_param(
                d, C.ZERO_OPTIMIZATION_PREFETCH_BUCKET_SIZE,
                C.ZERO_OPTIMIZATION_PREFETCH_BUCKET_SIZE_DEFAULT)),
            prefetch_mode=_validated_prefetch_mode(get_scalar_param(
                d, C.ZERO_OPTIMIZATION_PREFETCH_MODE,
                C.ZERO_OPTIMIZATION_PREFETCH_MODE_DEFAULT)),
            param_persistence_threshold=int(get_scalar_param(
                d, C.ZERO_OPTIMIZATION_PARAM_PERSISTENCE_THRESHOLD,
                C.ZERO_OPTIMIZATION_PARAM_PERSISTENCE_THRESHOLD_DEFAULT)),
            gather_fp16_weights_on_model_save=get_scalar_param(
                d, C.ZERO_OPTIMIZATION_GATHER_FP16_WEIGHTS_ON_MODEL_SAVE,
                C.ZERO_OPTIMIZATION_GATHER_FP16_WEIGHTS_ON_MODEL_SAVE_DEFAULT),
            ignore_unused_parameters=get_scalar_param(
                d, C.ZERO_OPTIMIZATION_IGNORE_UNUSED_PARAMETERS,
                C.ZERO_OPTIMIZATION_IGNORE_UNUSED_PARAMETERS_DEFAULT),
            legacy_stage1=get_scalar_param(
                d, C.ZERO_OPTIMIZATION_LEGACY_STAGE1,
                C.ZERO_OPTIMIZATION_LEGACY_STAGE1_DEFAULT),
            elastic_checkpoint=get_scalar_param(
                d, C.ZERO_OPTIMIZATION_ELASTIC_CHECKPOINT,
                C.ZERO_OPTIMIZATION_ELASTIC_CHECKPOINT_DEFAULT),
            cpu_offload=cpu_offload,
            cpu_offload_params=cpu_offload_params,
            low_bandwidth=ZeroLowBandwidthConfig.from_dict(
                d.get(C.ZERO_OPTIMIZATION_LOW_BANDWIDTH)),
        )


@dataclass
class AioConfig:
    """Reference: deepspeed/runtime/swap_tensor/aio_config.py:18, plus the
    `backend` engine selector (io_uring | batched | threadpool | auto —
    constants.AIO_BACKENDS, resolved at handle-creation time by
    swap_tensor/aio_handle.resolve_backend with a loud fallback log when
    io_uring is requested but the kernel can't deliver it)."""
    block_size: int = C.AIO_BLOCK_SIZE_DEFAULT
    queue_depth: int = C.AIO_QUEUE_DEPTH_DEFAULT
    thread_count: int = C.AIO_THREAD_COUNT_DEFAULT
    single_submit: bool = C.AIO_SINGLE_SUBMIT_DEFAULT
    overlap_events: bool = C.AIO_OVERLAP_EVENTS_DEFAULT
    backend: str = C.AIO_BACKEND_DEFAULT

    @staticmethod
    def from_dict(d: Optional[Dict[str, Any]]) -> "AioConfig":
        d = d or {}
        block_size = int(get_scalar_param(d, C.AIO_BLOCK_SIZE,
                                          C.AIO_BLOCK_SIZE_DEFAULT))
        if block_size < C.AIO_BLOCK_SIZE_MIN:
            raise DeepSpeedConfigError(
                f"aio.{C.AIO_BLOCK_SIZE}={block_size} — below the "
                f"{C.AIO_BLOCK_SIZE_MIN}-byte I/O alignment floor")
        queue_depth = int(get_scalar_param(d, C.AIO_QUEUE_DEPTH,
                                           C.AIO_QUEUE_DEPTH_DEFAULT))
        if queue_depth < 1:
            raise DeepSpeedConfigError(
                f"aio.{C.AIO_QUEUE_DEPTH}={queue_depth} — must be >= 1")
        thread_count = int(get_scalar_param(d, C.AIO_THREAD_COUNT,
                                            C.AIO_THREAD_COUNT_DEFAULT))
        if thread_count < 1:
            raise DeepSpeedConfigError(
                f"aio.{C.AIO_THREAD_COUNT}={thread_count} — must be >= 1")
        backend = get_scalar_param(d, C.AIO_BACKEND, C.AIO_BACKEND_DEFAULT)
        if backend not in C.AIO_BACKENDS:
            raise DeepSpeedConfigError(
                f"aio.{C.AIO_BACKEND}={backend!r} — supported backends "
                f"are {list(C.AIO_BACKENDS)}")
        return AioConfig(
            block_size=block_size,
            queue_depth=queue_depth,
            thread_count=thread_count,
            single_submit=get_scalar_param(d, C.AIO_SINGLE_SUBMIT,
                                           C.AIO_SINGLE_SUBMIT_DEFAULT),
            overlap_events=get_scalar_param(d, C.AIO_OVERLAP_EVENTS,
                                            C.AIO_OVERLAP_EVENTS_DEFAULT),
            backend=backend,
        )


@dataclass
class ActivationCheckpointingConfig:
    """Reference: runtime/activation_checkpointing/config.py:103."""
    partition_activations: bool = C.ACT_CHKPT_PARTITION_ACTIVATIONS_DEFAULT
    contiguous_memory_optimization: bool = (
        C.ACT_CHKPT_CONTIGUOUS_MEMORY_OPTIMIZATION_DEFAULT)
    cpu_checkpointing: bool = C.ACT_CHKPT_CPU_CHECKPOINTING_DEFAULT
    number_checkpoints: Optional[int] = C.ACT_CHKPT_NUMBER_CHECKPOINTS_DEFAULT
    synchronize_checkpoint_boundary: bool = (
        C.ACT_CHKPT_SYNCHRONIZE_CHECKPOINT_BOUNDARY_DEFAULT)
    profile: bool = C.ACT_CHKPT_PROFILE_DEFAULT

    @staticmethod
    def from_dict(d: Optional[Dict[str, Any]]) -> "ActivationCheckpointingConfig":
        d = d or {}
        return ActivationCheckpointingConfig(
            partition_activations=get_scalar_param(
                d, C.ACT_CHKPT_PARTITION_ACTIVATIONS,
                C.ACT_CHKPT_PARTITION_ACTIVATIONS_DEFAULT),
            contiguous_memory_optimization=get_scalar_param(
                d, C.ACT_CHKPT_CONTIGUOUS_MEMORY_OPTIMIZATION,
                C.ACT_CHKPT_CONTIGUOUS_MEMORY_OPTIMIZATION_DEFAULT),
            cpu_checkpointing=get_scalar_param(
                d, C.ACT_CHKPT_CPU_CHECKPOINTING,
                C.ACT_CHKPT_CPU_CHECKPOINTING_DEFAULT),
            number_checkpoints=get_scalar_param(
                d, C.ACT_CHKPT_NUMBER_CHECKPOINTS,
                C.ACT_CHKPT_NUMBER_CHECKPOINTS_DEFAULT),
            synchronize_checkpoint_boundary=get_scalar_param(
                d, C.ACT_CHKPT_SYNCHRONIZE_CHECKPOINT_BOUNDARY,
                C.ACT_CHKPT_SYNCHRONIZE_CHECKPOINT_BOUNDARY_DEFAULT),
            profile=get_scalar_param(d, C.ACT_CHKPT_PROFILE,
                                     C.ACT_CHKPT_PROFILE_DEFAULT),
        )


@dataclass
class FlopsProfilerConfig:
    """Reference: deepspeed/profiling/config.py:49."""
    enabled: bool = C.FLOPS_PROFILER_ENABLED_DEFAULT
    profile_step: int = C.FLOPS_PROFILER_PROFILE_STEP_DEFAULT
    module_depth: int = C.FLOPS_PROFILER_MODULE_DEPTH_DEFAULT
    top_modules: int = C.FLOPS_PROFILER_TOP_MODULES_DEFAULT
    detailed: bool = C.FLOPS_PROFILER_DETAILED_DEFAULT
    output_file: Optional[str] = C.FLOPS_PROFILER_OUTPUT_FILE_DEFAULT

    @staticmethod
    def from_dict(d: Optional[Dict[str, Any]]) -> "FlopsProfilerConfig":
        d = d or {}
        return FlopsProfilerConfig(
            enabled=get_scalar_param(d, C.FLOPS_PROFILER_ENABLED,
                                     C.FLOPS_PROFILER_ENABLED_DEFAULT),
            profile_step=get_scalar_param(d, C.FLOPS_PROFILER_PROFILE_STEP,
                                          C.FLOPS_PROFILER_PROFILE_STEP_DEFAULT),
            module_depth=get_scalar_param(d, C.FLOPS_PROFILER_MODULE_DEPTH,
                                          C.FLOPS_PROFILER_MODULE_DEPTH_DEFAULT),
            top_modules=get_scalar_param(d, C.FLOPS_PROFILER_TOP_MODULES,
                                         C.FLOPS_PROFILER_TOP_MODULES_DEFAULT),
            detailed=get_scalar_param(d, C.FLOPS_PROFILER_DETAILED,
                                      C.FLOPS_PROFILER_DETAILED_DEFAULT),
            output_file=get_scalar_param(d, C.FLOPS_PROFILER_OUTPUT_FILE,
                                         C.FLOPS_PROFILER_OUTPUT_FILE_DEFAULT),
        )


@dataclass
class TensorboardConfig:
    enabled: bool = C.TENSORBOARD_ENABLED_DEFAULT
    output_path: str = C.TENSORBOARD_OUTPUT_PATH_DEFAULT
    job_name: str = C.TENSORBOARD_JOB_NAME_DEFAULT
    # scalar-write cadence in optimizer steps; None inherits steps_per_print
    # (writing every step forces a device sync per step — see engine.step)
    write_interval: Optional[int] = C.TENSORBOARD_WRITE_INTERVAL_DEFAULT

    @staticmethod
    def from_dict(d: Optional[Dict[str, Any]]) -> "TensorboardConfig":
        d = d or {}
        interval = get_scalar_param(d, C.TENSORBOARD_WRITE_INTERVAL,
                                    C.TENSORBOARD_WRITE_INTERVAL_DEFAULT)
        if interval is not None and int(interval) <= 0:
            raise DeepSpeedConfigError(
                f"tensorboard.write_interval must be positive, got {interval}")
        return TensorboardConfig(
            enabled=get_scalar_param(d, C.TENSORBOARD_ENABLED,
                                     C.TENSORBOARD_ENABLED_DEFAULT),
            output_path=get_scalar_param(d, C.TENSORBOARD_OUTPUT_PATH,
                                         C.TENSORBOARD_OUTPUT_PATH_DEFAULT),
            job_name=get_scalar_param(d, C.TENSORBOARD_JOB_NAME,
                                      C.TENSORBOARD_JOB_NAME_DEFAULT),
            write_interval=None if interval is None else int(interval),
        )


@dataclass
class FusedStepConfig:
    """Fused whole-step train program (docs/fused_step.md): gradient
    accumulation as an in-program ``lax.scan`` + the optimizer apply in the
    same compiled program — one XLA dispatch per optimizer step.  Off by
    default; the engine falls back to the modular forward/backward/step
    loop automatically whenever a host-interactive feature is active (the
    fallback matrix is logged and exposed as ``engine.fused_step_reason``).
    """
    enabled: bool = C.FUSED_STEP_ENABLED_DEFAULT

    @staticmethod
    def from_dict(d: Optional[Dict[str, Any]]) -> "FusedStepConfig":
        d = d or {}
        return FusedStepConfig(
            enabled=get_scalar_param(d, C.FUSED_STEP_ENABLED,
                                     C.FUSED_STEP_ENABLED_DEFAULT))


@dataclass
class MonitorCaptureConfig:
    """Anomaly-triggered deep profiling (monitor/capture.py): a bounded
    ``jax.profiler`` trace capture armed when a reconciliation band is
    breached or a fleet health event flags THIS host.  Off by default;
    rate-limited so a persistently-bad band yields a few traces, never a
    full-run profile."""
    enabled: bool = C.MONITOR_CAPTURE_ENABLED_DEFAULT
    steps: int = C.MONITOR_CAPTURE_STEPS_DEFAULT
    max_captures: int = C.MONITOR_CAPTURE_MAX_CAPTURES_DEFAULT
    cooldown_steps: int = C.MONITOR_CAPTURE_COOLDOWN_STEPS_DEFAULT
    output_path: str = C.MONITOR_CAPTURE_OUTPUT_PATH_DEFAULT

    @staticmethod
    def from_dict(d: Optional[Dict[str, Any]]) -> "MonitorCaptureConfig":
        if d is True:
            # the natural shorthand for "just turn it on"
            d = {C.MONITOR_CAPTURE_ENABLED: True}
        elif d in (None, False):
            d = {}
        elif not isinstance(d, dict):
            raise DeepSpeedConfigError(
                f"monitor.capture must be a config object (or true/"
                f"false), got {d!r}")
        cfg = MonitorCaptureConfig(
            enabled=bool(get_scalar_param(
                d, C.MONITOR_CAPTURE_ENABLED,
                C.MONITOR_CAPTURE_ENABLED_DEFAULT)),
            steps=int(get_scalar_param(
                d, C.MONITOR_CAPTURE_STEPS,
                C.MONITOR_CAPTURE_STEPS_DEFAULT)),
            max_captures=int(get_scalar_param(
                d, C.MONITOR_CAPTURE_MAX_CAPTURES,
                C.MONITOR_CAPTURE_MAX_CAPTURES_DEFAULT)),
            cooldown_steps=int(get_scalar_param(
                d, C.MONITOR_CAPTURE_COOLDOWN_STEPS,
                C.MONITOR_CAPTURE_COOLDOWN_STEPS_DEFAULT)),
            output_path=get_scalar_param(
                d, C.MONITOR_CAPTURE_OUTPUT_PATH,
                C.MONITOR_CAPTURE_OUTPUT_PATH_DEFAULT) or "",
        )
        if cfg.steps <= 0:
            raise DeepSpeedConfigError(
                f"monitor.capture.steps must be positive, got {cfg.steps}")
        if cfg.max_captures <= 0:
            raise DeepSpeedConfigError(
                "monitor.capture.max_captures must be positive, got "
                f"{cfg.max_captures}")
        if cfg.cooldown_steps < 0:
            raise DeepSpeedConfigError(
                "monitor.capture.cooldown_steps must be >= 0, got "
                f"{cfg.cooldown_steps}")
        return cfg


@dataclass
class MonitorMoeConfig:
    """MoE routing observability (monitor/moe.py, docs/telemetry.md):
    device-resident RoutingStats accumulation in the traced step
    programs, one ``moe`` record + ExpertPopularitySnapshot per flush
    window, fleet load-skew slots, and the three MoE health rules.
    Off by default; on a dense model it is inert (no gate ever emits)."""
    enabled: bool = C.MONITOR_MOE_ENABLED_DEFAULT
    popularity_ewma_alpha: float = C.MONITOR_MOE_EWMA_ALPHA_DEFAULT
    hot_k: int = C.MONITOR_MOE_HOT_K_DEFAULT
    dead_expert_threshold: float = (
        C.MONITOR_MOE_DEAD_EXPERT_THRESHOLD_DEFAULT)
    dead_expert_windows: int = C.MONITOR_MOE_DEAD_EXPERT_WINDOWS_DEFAULT
    entropy_floor: float = C.MONITOR_MOE_ENTROPY_FLOOR_DEFAULT
    collapse_windows: int = C.MONITOR_MOE_COLLAPSE_WINDOWS_DEFAULT
    ep_imbalance_ratio: float = C.MONITOR_MOE_EP_IMBALANCE_RATIO_DEFAULT
    ep_imbalance_windows: int = (
        C.MONITOR_MOE_EP_IMBALANCE_WINDOWS_DEFAULT)

    @staticmethod
    def from_dict(d: Optional[Dict[str, Any]]) -> "MonitorMoeConfig":
        if d is True:  # shorthand, like monitor.capture
            d = {C.MONITOR_MOE_ENABLED: True}
        elif d in (None, False):
            d = {}
        elif not isinstance(d, dict):
            raise DeepSpeedConfigError(
                f"monitor.moe must be a config object (or true/false), "
                f"got {d!r}")
        cfg = MonitorMoeConfig(
            enabled=bool(get_scalar_param(
                d, C.MONITOR_MOE_ENABLED, C.MONITOR_MOE_ENABLED_DEFAULT)),
            popularity_ewma_alpha=float(get_scalar_param(
                d, C.MONITOR_MOE_EWMA_ALPHA,
                C.MONITOR_MOE_EWMA_ALPHA_DEFAULT)),
            hot_k=int(get_scalar_param(
                d, C.MONITOR_MOE_HOT_K, C.MONITOR_MOE_HOT_K_DEFAULT)),
            dead_expert_threshold=float(get_scalar_param(
                d, C.MONITOR_MOE_DEAD_EXPERT_THRESHOLD,
                C.MONITOR_MOE_DEAD_EXPERT_THRESHOLD_DEFAULT)),
            dead_expert_windows=int(get_scalar_param(
                d, C.MONITOR_MOE_DEAD_EXPERT_WINDOWS,
                C.MONITOR_MOE_DEAD_EXPERT_WINDOWS_DEFAULT)),
            entropy_floor=float(get_scalar_param(
                d, C.MONITOR_MOE_ENTROPY_FLOOR,
                C.MONITOR_MOE_ENTROPY_FLOOR_DEFAULT)),
            collapse_windows=int(get_scalar_param(
                d, C.MONITOR_MOE_COLLAPSE_WINDOWS,
                C.MONITOR_MOE_COLLAPSE_WINDOWS_DEFAULT)),
            ep_imbalance_ratio=float(get_scalar_param(
                d, C.MONITOR_MOE_EP_IMBALANCE_RATIO,
                C.MONITOR_MOE_EP_IMBALANCE_RATIO_DEFAULT)),
            ep_imbalance_windows=int(get_scalar_param(
                d, C.MONITOR_MOE_EP_IMBALANCE_WINDOWS,
                C.MONITOR_MOE_EP_IMBALANCE_WINDOWS_DEFAULT)),
        )
        if not 0.0 < cfg.popularity_ewma_alpha <= 1.0:
            raise DeepSpeedConfigError(
                "monitor.moe.popularity_ewma_alpha must be in (0, 1], "
                f"got {cfg.popularity_ewma_alpha}")
        if cfg.hot_k < 1:
            raise DeepSpeedConfigError(
                f"monitor.moe.hot_k must be >= 1, got {cfg.hot_k}")
        if not 0.0 <= cfg.dead_expert_threshold < 1.0:
            raise DeepSpeedConfigError(
                "monitor.moe.dead_expert_threshold must be in [0, 1) — "
                "a fraction of the fair per-expert share, got "
                f"{cfg.dead_expert_threshold}")
        if not 0.0 <= cfg.entropy_floor < 1.0:
            raise DeepSpeedConfigError(
                "monitor.moe.entropy_floor must be in [0, 1) — router "
                "entropy is normalized by ln(num_experts), got "
                f"{cfg.entropy_floor}")
        if cfg.ep_imbalance_ratio <= 1.0:
            raise DeepSpeedConfigError(
                "monitor.moe.ep_imbalance_ratio must be > 1.0 (a hot "
                "host carries MORE than the peer-median load), got "
                f"{cfg.ep_imbalance_ratio}")
        for name, v in ((C.MONITOR_MOE_DEAD_EXPERT_WINDOWS,
                         cfg.dead_expert_windows),
                        (C.MONITOR_MOE_COLLAPSE_WINDOWS,
                         cfg.collapse_windows),
                        (C.MONITOR_MOE_EP_IMBALANCE_WINDOWS,
                         cfg.ep_imbalance_windows)):
            if v < 1:
                raise DeepSpeedConfigError(
                    f"monitor.moe.{name} must be >= 1, got {v}")
        return cfg


@dataclass
class MonitorConfig:
    """Runtime telemetry block (docs/telemetry.md): per-step structured
    metric records, pluggable writers, optional Chrome/Perfetto trace
    export, and the measured-vs-predicted reconciliation report — plus
    the fleet layer (cross-host aggregation + straggler/divergence
    health, heartbeat liveness, anomaly-triggered profiler capture).
    Off by default; with it on, all host reads AND all cross-host
    aggregation traffic stay batched at flush-window boundaries (the
    async-host-loop discipline)."""
    enabled: bool = C.MONITOR_ENABLED_DEFAULT
    output_path: str = C.MONITOR_OUTPUT_PATH_DEFAULT
    job_name: str = C.MONITOR_JOB_NAME_DEFAULT
    writers: tuple = C.MONITOR_WRITERS_DEFAULT
    write_interval: Optional[int] = C.MONITOR_WRITE_INTERVAL_DEFAULT
    trace: bool = C.MONITOR_TRACE_DEFAULT
    trace_steps: int = C.MONITOR_TRACE_STEPS_DEFAULT
    reconcile: bool = C.MONITOR_RECONCILE_DEFAULT
    step_time_ratio_max: float = C.MONITOR_STEP_TIME_RATIO_MAX_DEFAULT
    hbm_ratio_max: float = C.MONITOR_HBM_RATIO_MAX_DEFAULT
    swap_min_vs_ceiling: float = C.MONITOR_SWAP_MIN_VS_CEILING_DEFAULT
    fleet: bool = C.MONITOR_FLEET_DEFAULT
    heartbeat: bool = C.MONITOR_HEARTBEAT_DEFAULT
    straggler_zscore: float = C.MONITOR_STRAGGLER_ZSCORE_DEFAULT
    straggler_min_ratio: float = C.MONITOR_STRAGGLER_MIN_RATIO_DEFAULT
    divergence_rel_spread: float = C.MONITOR_DIVERGENCE_REL_SPREAD_DEFAULT
    health_warmup_windows: int = C.MONITOR_HEALTH_WARMUP_WINDOWS_DEFAULT
    fleet_exchange_deadline_s: float = (
        C.MONITOR_FLEET_EXCHANGE_DEADLINE_S_DEFAULT)
    capture: MonitorCaptureConfig = field(
        default_factory=MonitorCaptureConfig)
    moe: MonitorMoeConfig = field(default_factory=MonitorMoeConfig)

    @staticmethod
    def from_dict(d: Optional[Dict[str, Any]]) -> "MonitorConfig":
        d = d or {}
        writers = d.get(C.MONITOR_WRITERS, C.MONITOR_WRITERS_DEFAULT)
        if isinstance(writers, str):
            writers = (writers,)
        try:
            writers = tuple(writers)
        except TypeError:
            raise DeepSpeedConfigError(
                f"monitor.writers must be a list of backend names "
                f"(supported: {list(C.MONITOR_WRITER_KINDS)}), got "
                f"{writers!r}")
        interval = get_scalar_param(d, C.MONITOR_WRITE_INTERVAL,
                                    C.MONITOR_WRITE_INTERVAL_DEFAULT)
        cfg = MonitorConfig(
            enabled=get_scalar_param(d, C.MONITOR_ENABLED,
                                     C.MONITOR_ENABLED_DEFAULT),
            output_path=get_scalar_param(d, C.MONITOR_OUTPUT_PATH,
                                         C.MONITOR_OUTPUT_PATH_DEFAULT),
            job_name=get_scalar_param(d, C.MONITOR_JOB_NAME,
                                      C.MONITOR_JOB_NAME_DEFAULT),
            writers=writers,
            write_interval=None if interval is None else int(interval),
            trace=bool(get_scalar_param(d, C.MONITOR_TRACE,
                                        C.MONITOR_TRACE_DEFAULT)),
            trace_steps=int(get_scalar_param(
                d, C.MONITOR_TRACE_STEPS, C.MONITOR_TRACE_STEPS_DEFAULT)),
            reconcile=bool(get_scalar_param(d, C.MONITOR_RECONCILE,
                                            C.MONITOR_RECONCILE_DEFAULT)),
            step_time_ratio_max=float(get_scalar_param(
                d, C.MONITOR_STEP_TIME_RATIO_MAX,
                C.MONITOR_STEP_TIME_RATIO_MAX_DEFAULT)),
            hbm_ratio_max=float(get_scalar_param(
                d, C.MONITOR_HBM_RATIO_MAX,
                C.MONITOR_HBM_RATIO_MAX_DEFAULT)),
            swap_min_vs_ceiling=float(get_scalar_param(
                d, C.MONITOR_SWAP_MIN_VS_CEILING,
                C.MONITOR_SWAP_MIN_VS_CEILING_DEFAULT)),
            fleet=bool(get_scalar_param(d, C.MONITOR_FLEET,
                                        C.MONITOR_FLEET_DEFAULT)),
            heartbeat=bool(get_scalar_param(d, C.MONITOR_HEARTBEAT,
                                            C.MONITOR_HEARTBEAT_DEFAULT)),
            straggler_zscore=float(get_scalar_param(
                d, C.MONITOR_STRAGGLER_ZSCORE,
                C.MONITOR_STRAGGLER_ZSCORE_DEFAULT)),
            straggler_min_ratio=float(get_scalar_param(
                d, C.MONITOR_STRAGGLER_MIN_RATIO,
                C.MONITOR_STRAGGLER_MIN_RATIO_DEFAULT)),
            divergence_rel_spread=float(get_scalar_param(
                d, C.MONITOR_DIVERGENCE_REL_SPREAD,
                C.MONITOR_DIVERGENCE_REL_SPREAD_DEFAULT)),
            health_warmup_windows=int(get_scalar_param(
                d, C.MONITOR_HEALTH_WARMUP_WINDOWS,
                C.MONITOR_HEALTH_WARMUP_WINDOWS_DEFAULT)),
            fleet_exchange_deadline_s=float(get_scalar_param(
                d, C.MONITOR_FLEET_EXCHANGE_DEADLINE_S,
                C.MONITOR_FLEET_EXCHANGE_DEADLINE_S_DEFAULT)),
            capture=MonitorCaptureConfig.from_dict(
                d.get(C.MONITOR_CAPTURE)),
            moe=MonitorMoeConfig.from_dict(d.get(C.MONITOR_MOE)),
        )
        unknown = [w for w in cfg.writers if w not in C.MONITOR_WRITER_KINDS]
        if unknown:
            raise DeepSpeedConfigError(
                f"monitor.writers contains unknown backend(s) {unknown} — "
                f"supported: {list(C.MONITOR_WRITER_KINDS)}")
        if cfg.enabled and not cfg.writers:
            raise DeepSpeedConfigError(
                "monitor.enabled requires at least one writer backend "
                f"(supported: {list(C.MONITOR_WRITER_KINDS)})")
        if cfg.write_interval is not None and cfg.write_interval <= 0:
            raise DeepSpeedConfigError(
                "monitor.write_interval must be positive, got "
                f"{cfg.write_interval}")
        if cfg.trace_steps <= 0:
            raise DeepSpeedConfigError(
                f"monitor.trace_steps must be positive, got "
                f"{cfg.trace_steps}")
        if cfg.step_time_ratio_max <= 1.0:
            raise DeepSpeedConfigError(
                "monitor.step_time_ratio_max must be > 1.0 (measured is "
                f"compared against a LOWER bound), got "
                f"{cfg.step_time_ratio_max}")
        if cfg.hbm_ratio_max <= 1.0:
            raise DeepSpeedConfigError(
                "monitor.hbm_ratio_max must be > 1.0, got "
                f"{cfg.hbm_ratio_max}")
        if not 0.0 <= cfg.swap_min_vs_ceiling <= 1.0:
            raise DeepSpeedConfigError(
                "monitor.swap_min_vs_ceiling must be in [0, 1], got "
                f"{cfg.swap_min_vs_ceiling}")
        if cfg.straggler_zscore <= 0:
            raise DeepSpeedConfigError(
                "monitor.straggler_zscore must be positive, got "
                f"{cfg.straggler_zscore}")
        if cfg.straggler_min_ratio < 1.0:
            raise DeepSpeedConfigError(
                "monitor.straggler_min_ratio must be >= 1.0 (a straggler "
                "is SLOWER than the fleet median), got "
                f"{cfg.straggler_min_ratio}")
        if cfg.divergence_rel_spread <= 0:
            raise DeepSpeedConfigError(
                "monitor.divergence_rel_spread must be positive, got "
                f"{cfg.divergence_rel_spread}")
        if cfg.health_warmup_windows < 0:
            raise DeepSpeedConfigError(
                "monitor.health_warmup_windows must be >= 0, got "
                f"{cfg.health_warmup_windows}")
        if cfg.fleet_exchange_deadline_s < 0:
            raise DeepSpeedConfigError(
                "monitor.fleet_exchange_deadline_s must be >= 0 "
                f"(0 disables the watchdog), got "
                f"{cfg.fleet_exchange_deadline_s}")
        return cfg


def validate_hw_constants(hw: Dict[str, Any],
                          context: str = "analysis") -> Dict[str, float]:
    """Positivity gate for the canonical hardware-model constants
    (C.ANALYSIS_HW_KEYS: hw_peak_tflops / hw_hbm_gbps / hw_ici_gbps).
    Single-sourced so the ``analysis`` config block and the autotuner's
    calibration file validate the SAME names the same way — returns the
    validated subset as floats."""
    out: Dict[str, float] = {}
    for key in C.ANALYSIS_HW_KEYS:
        if key not in hw or hw[key] is None:
            continue
        val = float(hw[key])
        if val <= 0:
            raise DeepSpeedConfigError(
                f"{context}.{key} must be > 0, got {val}")
        out[key] = val
    return out


@dataclass
class AnalysisConfig:
    """Program Auditor block (docs/program_auditor.md): static jaxpr lint
    of the traced step programs at engine init, plus the runtime
    recompile guard.  ``mode`` "off" (default) skips everything; "warn"
    logs findings; "error" raises ProgramAuditError on error-severity
    findings (CI posture)."""
    mode: str = C.ANALYSIS_MODE_DEFAULT
    comm_budget_mb: Optional[float] = C.ANALYSIS_COMM_BUDGET_MB_DEFAULT
    max_retraces: int = C.ANALYSIS_MAX_RETRACES_DEFAULT
    donation_min_mb: float = C.ANALYSIS_DONATION_MIN_MB_DEFAULT
    dtype_min_elements: int = C.ANALYSIS_DTYPE_MIN_ELEMENTS_DEFAULT
    expected_signature: Optional[str] = (
        C.ANALYSIS_EXPECTED_SIGNATURE_DEFAULT)
    hbm_budget_mb: Optional[float] = C.ANALYSIS_HBM_BUDGET_MB_DEFAULT
    require_overlap: bool = C.ANALYSIS_REQUIRE_OVERLAP_DEFAULT
    overlap_min_hidden_fraction: float = (
        C.ANALYSIS_OVERLAP_MIN_HIDDEN_DEFAULT)
    hw_peak_tflops: float = C.ANALYSIS_HW_PEAK_TFLOPS_DEFAULT
    hw_hbm_gbps: float = C.ANALYSIS_HW_HBM_GBPS_DEFAULT
    hw_ici_gbps: float = C.ANALYSIS_HW_ICI_GBPS_DEFAULT
    # HLO-level SPMD audit (analysis/hlo_audit.py): compile each audited
    # program through XLA's SPMD partitioner and cross-check the jaxpr
    # wire story against the collectives the compiler actually inserted
    hlo_audit: bool = C.ANALYSIS_HLO_AUDIT_DEFAULT
    require_spmd_match: bool = C.ANALYSIS_REQUIRE_SPMD_MATCH_DEFAULT
    spmd_reshard_min_mb: float = C.ANALYSIS_SPMD_RESHARD_MIN_MB_DEFAULT
    spmd_match_tolerance: float = C.ANALYSIS_SPMD_MATCH_TOLERANCE_DEFAULT

    @property
    def enabled(self) -> bool:
        return self.mode != "off"

    @staticmethod
    def from_dict(d: Optional[Dict[str, Any]]) -> "AnalysisConfig":
        d = d or {}
        budget = get_scalar_param(d, C.ANALYSIS_COMM_BUDGET_MB,
                                  C.ANALYSIS_COMM_BUDGET_MB_DEFAULT)
        hbm_budget = get_scalar_param(d, C.ANALYSIS_HBM_BUDGET_MB,
                                      C.ANALYSIS_HBM_BUDGET_MB_DEFAULT)
        cfg = AnalysisConfig(
            mode=get_scalar_param(d, C.ANALYSIS_MODE,
                                  C.ANALYSIS_MODE_DEFAULT),
            comm_budget_mb=None if budget is None else float(budget),
            max_retraces=int(get_scalar_param(
                d, C.ANALYSIS_MAX_RETRACES,
                C.ANALYSIS_MAX_RETRACES_DEFAULT)),
            donation_min_mb=float(get_scalar_param(
                d, C.ANALYSIS_DONATION_MIN_MB,
                C.ANALYSIS_DONATION_MIN_MB_DEFAULT)),
            dtype_min_elements=int(get_scalar_param(
                d, C.ANALYSIS_DTYPE_MIN_ELEMENTS,
                C.ANALYSIS_DTYPE_MIN_ELEMENTS_DEFAULT)),
            expected_signature=get_scalar_param(
                d, C.ANALYSIS_EXPECTED_SIGNATURE,
                C.ANALYSIS_EXPECTED_SIGNATURE_DEFAULT),
            hbm_budget_mb=None if hbm_budget is None else float(hbm_budget),
            require_overlap=bool(get_scalar_param(
                d, C.ANALYSIS_REQUIRE_OVERLAP,
                C.ANALYSIS_REQUIRE_OVERLAP_DEFAULT)),
            overlap_min_hidden_fraction=float(get_scalar_param(
                d, C.ANALYSIS_OVERLAP_MIN_HIDDEN,
                C.ANALYSIS_OVERLAP_MIN_HIDDEN_DEFAULT)),
            hw_peak_tflops=float(get_scalar_param(
                d, C.ANALYSIS_HW_PEAK_TFLOPS,
                C.ANALYSIS_HW_PEAK_TFLOPS_DEFAULT)),
            hw_hbm_gbps=float(get_scalar_param(
                d, C.ANALYSIS_HW_HBM_GBPS,
                C.ANALYSIS_HW_HBM_GBPS_DEFAULT)),
            hw_ici_gbps=float(get_scalar_param(
                d, C.ANALYSIS_HW_ICI_GBPS,
                C.ANALYSIS_HW_ICI_GBPS_DEFAULT)),
            hlo_audit=bool(get_scalar_param(
                d, C.ANALYSIS_HLO_AUDIT, C.ANALYSIS_HLO_AUDIT_DEFAULT)),
            require_spmd_match=bool(get_scalar_param(
                d, C.ANALYSIS_REQUIRE_SPMD_MATCH,
                C.ANALYSIS_REQUIRE_SPMD_MATCH_DEFAULT)),
            spmd_reshard_min_mb=float(get_scalar_param(
                d, C.ANALYSIS_SPMD_RESHARD_MIN_MB,
                C.ANALYSIS_SPMD_RESHARD_MIN_MB_DEFAULT)),
            spmd_match_tolerance=float(get_scalar_param(
                d, C.ANALYSIS_SPMD_MATCH_TOLERANCE,
                C.ANALYSIS_SPMD_MATCH_TOLERANCE_DEFAULT)),
        )
        if cfg.mode not in C.ANALYSIS_MODES:
            raise DeepSpeedConfigError(
                f"analysis.mode={cfg.mode!r} — supported modes are "
                f"{list(C.ANALYSIS_MODES)}")
        if cfg.comm_budget_mb is not None and cfg.comm_budget_mb < 0:
            raise DeepSpeedConfigError(
                "analysis.comm_budget_mb must be >= 0, got "
                f"{cfg.comm_budget_mb}")
        if cfg.max_retraces < 1:
            raise DeepSpeedConfigError(
                f"analysis.max_retraces must be >= 1, got "
                f"{cfg.max_retraces}")
        if cfg.hbm_budget_mb is not None and cfg.hbm_budget_mb < 0:
            raise DeepSpeedConfigError(
                "analysis.hbm_budget_mb must be >= 0, got "
                f"{cfg.hbm_budget_mb}")
        if not 0.0 < cfg.overlap_min_hidden_fraction <= 1.0:
            raise DeepSpeedConfigError(
                "analysis.overlap_min_hidden_fraction must be in (0, 1], "
                f"got {cfg.overlap_min_hidden_fraction}")
        if cfg.spmd_reshard_min_mb < 0:
            raise DeepSpeedConfigError(
                "analysis.spmd_reshard_min_mb must be >= 0, got "
                f"{cfg.spmd_reshard_min_mb}")
        if cfg.spmd_match_tolerance < 0:
            raise DeepSpeedConfigError(
                "analysis.spmd_match_tolerance must be >= 0, got "
                f"{cfg.spmd_match_tolerance}")
        validate_hw_constants({
            C.ANALYSIS_HW_PEAK_TFLOPS: cfg.hw_peak_tflops,
            C.ANALYSIS_HW_HBM_GBPS: cfg.hw_hbm_gbps,
            C.ANALYSIS_HW_ICI_GBPS: cfg.hw_ici_gbps})
        return cfg

    def hw_overridden(self, hw: Dict[str, Any]) -> "AnalysisConfig":
        """A copy with the canonical hardware constants replaced from a
        validated mapping (the autotuner's calibration-file hook) — keys
        outside C.ANALYSIS_HW_KEYS are rejected by the shared gate."""
        from dataclasses import replace
        valid = validate_hw_constants(hw, context="calibration")
        return replace(
            self,
            hw_peak_tflops=valid.get(C.ANALYSIS_HW_PEAK_TFLOPS,
                                     self.hw_peak_tflops),
            hw_hbm_gbps=valid.get(C.ANALYSIS_HW_HBM_GBPS,
                                  self.hw_hbm_gbps),
            hw_ici_gbps=valid.get(C.ANALYSIS_HW_ICI_GBPS,
                                  self.hw_ici_gbps))


def _as_tuple(val, cast) -> tuple:
    """Coerce a config axis (scalar or list) to a tuple of `cast`."""
    if isinstance(val, (list, tuple)):
        return tuple(cast(v) for v in val)
    return (cast(val),)


@dataclass
class AutotuningConfig:
    """Config-autotuner block (docs/autotuner.md): the offline search
    bounds, fixed knobs, and budget for ``python -m
    deepspeed_tpu.analysis tune``.  Purely a SEARCH description — the
    engine never reads it, so a bench-ready emitted config can carry the
    block that produced it as provenance."""
    chips: Optional[int] = C.AUTOTUNING_CHIPS_DEFAULT
    global_batch: Optional[int] = C.AUTOTUNING_GLOBAL_BATCH_DEFAULT
    top_k: int = C.AUTOTUNING_TOP_K_DEFAULT
    hbm_budget_mb: Optional[float] = C.AUTOTUNING_HBM_BUDGET_MB_DEFAULT
    max_candidates: int = C.AUTOTUNING_MAX_CANDIDATES_DEFAULT
    mesh_model: tuple = C.AUTOTUNING_MESH_MODEL_DEFAULT
    mesh_expert: tuple = C.AUTOTUNING_MESH_EXPERT_DEFAULT
    zero_stages: tuple = C.AUTOTUNING_ZERO_STAGES_DEFAULT
    stage3_variants: tuple = C.AUTOTUNING_STAGE3_VARIANTS_DEFAULT
    prefetch_modes: tuple = C.AUTOTUNING_PREFETCH_MODES_DEFAULT
    stage3_bucket_sizes: tuple = C.AUTOTUNING_STAGE3_BUCKET_SIZES_DEFAULT
    micro_batches: Optional[tuple] = C.AUTOTUNING_MICRO_BATCHES_DEFAULT
    qwz_bits: tuple = C.AUTOTUNING_QWZ_BITS_DEFAULT
    qgz_bits: tuple = C.AUTOTUNING_QGZ_BITS_DEFAULT
    hpz_group_sizes: tuple = C.AUTOTUNING_HPZ_GROUP_SIZES_DEFAULT
    fused: tuple = C.AUTOTUNING_FUSED_DEFAULT
    fused_collective_matmul: tuple = C.AUTOTUNING_FCM_DEFAULT
    onebit: tuple = C.AUTOTUNING_ONEBIT_DEFAULT
    offload: tuple = C.AUTOTUNING_OFFLOAD_TIERS_DEFAULT
    nvme_prefetch_depths: tuple = C.AUTOTUNING_NVME_PREFETCH_DEPTHS_DEFAULT
    opt_pipeline_depths: tuple = C.AUTOTUNING_OPT_PIPELINE_DEPTHS_DEFAULT
    fixed: Optional[Dict[str, Any]] = C.AUTOTUNING_FIXED_DEFAULT
    calibration_file: Optional[str] = C.AUTOTUNING_CALIBRATION_FILE_DEFAULT

    @staticmethod
    def from_dict(d: Optional[Dict[str, Any]]) -> "AutotuningConfig":
        d = d or {}
        chips = get_scalar_param(d, C.AUTOTUNING_CHIPS,
                                 C.AUTOTUNING_CHIPS_DEFAULT)
        gb = get_scalar_param(d, C.AUTOTUNING_GLOBAL_BATCH,
                              C.AUTOTUNING_GLOBAL_BATCH_DEFAULT)
        budget = get_scalar_param(d, C.AUTOTUNING_HBM_BUDGET_MB,
                                  C.AUTOTUNING_HBM_BUDGET_MB_DEFAULT)
        micro = d.get(C.AUTOTUNING_MICRO_BATCHES,
                      C.AUTOTUNING_MICRO_BATCHES_DEFAULT)
        cfg = AutotuningConfig(
            chips=None if chips is None else int(chips),
            global_batch=None if gb is None else int(gb),
            top_k=int(get_scalar_param(d, C.AUTOTUNING_TOP_K,
                                       C.AUTOTUNING_TOP_K_DEFAULT)),
            hbm_budget_mb=None if budget is None else float(budget),
            max_candidates=int(get_scalar_param(
                d, C.AUTOTUNING_MAX_CANDIDATES,
                C.AUTOTUNING_MAX_CANDIDATES_DEFAULT)),
            mesh_model=_as_tuple(d.get(
                C.AUTOTUNING_MESH_MODEL,
                C.AUTOTUNING_MESH_MODEL_DEFAULT), int),
            mesh_expert=_as_tuple(d.get(
                C.AUTOTUNING_MESH_EXPERT,
                C.AUTOTUNING_MESH_EXPERT_DEFAULT), int),
            zero_stages=_as_tuple(d.get(
                C.AUTOTUNING_ZERO_STAGES,
                C.AUTOTUNING_ZERO_STAGES_DEFAULT), int),
            stage3_variants=_as_tuple(d.get(
                C.AUTOTUNING_STAGE3_VARIANTS,
                C.AUTOTUNING_STAGE3_VARIANTS_DEFAULT), str),
            prefetch_modes=_as_tuple(d.get(
                C.AUTOTUNING_PREFETCH_MODES,
                C.AUTOTUNING_PREFETCH_MODES_DEFAULT), str),
            stage3_bucket_sizes=_as_tuple(d.get(
                C.AUTOTUNING_STAGE3_BUCKET_SIZES,
                C.AUTOTUNING_STAGE3_BUCKET_SIZES_DEFAULT), int),
            micro_batches=(None if micro is None
                           else _as_tuple(micro, int)),
            qwz_bits=_as_tuple(d.get(C.AUTOTUNING_QWZ_BITS,
                                     C.AUTOTUNING_QWZ_BITS_DEFAULT), int),
            qgz_bits=_as_tuple(d.get(C.AUTOTUNING_QGZ_BITS,
                                     C.AUTOTUNING_QGZ_BITS_DEFAULT), int),
            hpz_group_sizes=_as_tuple(d.get(
                C.AUTOTUNING_HPZ_GROUP_SIZES,
                C.AUTOTUNING_HPZ_GROUP_SIZES_DEFAULT), int),
            fused=_as_tuple(d.get(C.AUTOTUNING_FUSED,
                                  C.AUTOTUNING_FUSED_DEFAULT), bool),
            fused_collective_matmul=_as_tuple(
                d.get(C.AUTOTUNING_FCM, C.AUTOTUNING_FCM_DEFAULT), bool),
            onebit=_as_tuple(
                d.get(C.AUTOTUNING_ONEBIT, C.AUTOTUNING_ONEBIT_DEFAULT),
                bool),
            offload=_as_tuple(d.get(C.AUTOTUNING_OFFLOAD_TIERS,
                                    C.AUTOTUNING_OFFLOAD_TIERS_DEFAULT),
                              str),
            nvme_prefetch_depths=_as_tuple(d.get(
                C.AUTOTUNING_NVME_PREFETCH_DEPTHS,
                C.AUTOTUNING_NVME_PREFETCH_DEPTHS_DEFAULT), int),
            opt_pipeline_depths=_as_tuple(d.get(
                C.AUTOTUNING_OPT_PIPELINE_DEPTHS,
                C.AUTOTUNING_OPT_PIPELINE_DEPTHS_DEFAULT), int),
            fixed=d.get(C.AUTOTUNING_FIXED, C.AUTOTUNING_FIXED_DEFAULT),
            calibration_file=get_scalar_param(
                d, C.AUTOTUNING_CALIBRATION_FILE,
                C.AUTOTUNING_CALIBRATION_FILE_DEFAULT),
        )
        for knob, val, floor in ((C.AUTOTUNING_CHIPS, cfg.chips, 1),
                                 (C.AUTOTUNING_GLOBAL_BATCH,
                                  cfg.global_batch, 1),
                                 (C.AUTOTUNING_TOP_K, cfg.top_k, 1),
                                 (C.AUTOTUNING_MAX_CANDIDATES,
                                  cfg.max_candidates, 1)):
            if val is not None and val < floor:
                raise DeepSpeedConfigError(
                    f"autotuning.{knob} must be >= {floor}, got {val}")
        if cfg.hbm_budget_mb is not None and cfg.hbm_budget_mb <= 0:
            raise DeepSpeedConfigError(
                "autotuning.hbm_budget_mb must be > 0, got "
                f"{cfg.hbm_budget_mb}")
        for knob, vals, floor in (
                (C.AUTOTUNING_MESH_MODEL, cfg.mesh_model, 1),
                (C.AUTOTUNING_MESH_EXPERT, cfg.mesh_expert, 1),
                (C.AUTOTUNING_STAGE3_BUCKET_SIZES,
                 cfg.stage3_bucket_sizes, 1),
                (C.AUTOTUNING_NVME_PREFETCH_DEPTHS,
                 cfg.nvme_prefetch_depths, 1),
                (C.AUTOTUNING_OPT_PIPELINE_DEPTHS,
                 cfg.opt_pipeline_depths, 2),
                (C.AUTOTUNING_HPZ_GROUP_SIZES, cfg.hpz_group_sizes, 0),
                (C.AUTOTUNING_MICRO_BATCHES, cfg.micro_batches or (1,),
                 1)):
            if not vals or any(v < floor for v in vals):
                raise DeepSpeedConfigError(
                    f"autotuning.{knob} must be a non-empty list of "
                    f"ints >= {floor}, got {list(vals)}")
        for knob, vals, allowed in (
                (C.AUTOTUNING_ZERO_STAGES, cfg.zero_stages, (1, 2, 3)),
                (C.AUTOTUNING_STAGE3_VARIANTS, cfg.stage3_variants,
                 C.AUTOTUNING_STAGE3_VARIANTS_ALL),
                (C.AUTOTUNING_PREFETCH_MODES, cfg.prefetch_modes,
                 C.ZERO_OPTIMIZATION_PREFETCH_MODES),
                (C.AUTOTUNING_QWZ_BITS, cfg.qwz_bits, (0, 4, 8)),
                (C.AUTOTUNING_QGZ_BITS, cfg.qgz_bits, (0, 4, 8)),
                (C.AUTOTUNING_OFFLOAD_TIERS, cfg.offload,
                 C.AUTOTUNING_OFFLOAD_TIERS_ALL)):
            if not vals or any(v not in allowed for v in vals):
                raise DeepSpeedConfigError(
                    f"autotuning.{knob} values must be from "
                    f"{list(allowed)}, got {list(vals)}")
        if cfg.fixed is not None and not isinstance(cfg.fixed, dict):
            raise DeepSpeedConfigError(
                "autotuning.fixed must be a config-overlay dict, got "
                f"{type(cfg.fixed).__name__}")
        return cfg


@dataclass
class EigenvalueConfig:
    enabled: bool = C.EIGENVALUE_ENABLED_DEFAULT
    verbose: bool = C.EIGENVALUE_VERBOSE_DEFAULT
    max_iter: int = C.EIGENVALUE_MAX_ITER_DEFAULT
    tol: float = C.EIGENVALUE_TOL_DEFAULT
    stability: float = C.EIGENVALUE_STABILITY_DEFAULT
    gas_boundary_resolution: int = C.EIGENVALUE_GAS_BOUNDARY_RESOLUTION_DEFAULT
    layer_name: str = C.EIGENVALUE_LAYER_NAME_DEFAULT
    layer_num: int = C.EIGENVALUE_LAYER_NUM_DEFAULT

    @staticmethod
    def from_dict(d: Optional[Dict[str, Any]]) -> "EigenvalueConfig":
        d = d or {}
        return EigenvalueConfig(
            enabled=get_scalar_param(d, C.EIGENVALUE_ENABLED,
                                     C.EIGENVALUE_ENABLED_DEFAULT),
            verbose=get_scalar_param(d, C.EIGENVALUE_VERBOSE,
                                     C.EIGENVALUE_VERBOSE_DEFAULT),
            max_iter=get_scalar_param(d, C.EIGENVALUE_MAX_ITER,
                                      C.EIGENVALUE_MAX_ITER_DEFAULT),
            tol=get_scalar_param(d, C.EIGENVALUE_TOL, C.EIGENVALUE_TOL_DEFAULT),
            stability=get_scalar_param(d, C.EIGENVALUE_STABILITY,
                                       C.EIGENVALUE_STABILITY_DEFAULT),
            gas_boundary_resolution=get_scalar_param(
                d, C.EIGENVALUE_GAS_BOUNDARY_RESOLUTION,
                C.EIGENVALUE_GAS_BOUNDARY_RESOLUTION_DEFAULT),
            layer_name=get_scalar_param(d, C.EIGENVALUE_LAYER_NAME,
                                        C.EIGENVALUE_LAYER_NAME_DEFAULT),
            layer_num=get_scalar_param(d, C.EIGENVALUE_LAYER_NUM,
                                       C.EIGENVALUE_LAYER_NUM_DEFAULT),
        )


@dataclass
class PLDConfig:
    enabled: bool = C.PLD_ENABLED_DEFAULT
    theta: float = C.PLD_THETA_DEFAULT
    gamma: float = C.PLD_GAMMA_DEFAULT

    @staticmethod
    def from_dict(d: Optional[Dict[str, Any]]) -> "PLDConfig":
        d = d or {}
        return PLDConfig(
            enabled=get_scalar_param(d, C.PLD_ENABLED, C.PLD_ENABLED_DEFAULT),
            theta=get_scalar_param(d, C.PLD_THETA, C.PLD_THETA_DEFAULT),
            gamma=get_scalar_param(d, C.PLD_GAMMA, C.PLD_GAMMA_DEFAULT),
        )


@dataclass
class CurriculumConfig:
    enabled: bool = C.CURRICULUM_ENABLED_DEFAULT
    params: Dict[str, Any] = field(default_factory=dict)

    @staticmethod
    def from_dict(d: Optional[Dict[str, Any]]) -> "CurriculumConfig":
        d = d or {}
        return CurriculumConfig(
            enabled=get_scalar_param(d, C.CURRICULUM_ENABLED,
                                     C.CURRICULUM_ENABLED_DEFAULT),
            params=dict(d),
        )


@dataclass
class QuantizeTrainingConfig:
    """MoQ — reference: runtime/config.py get_quantize_enabled + quantize keys."""
    enabled: bool = C.QUANTIZE_TRAINING_ENABLED_DEFAULT
    quantize_verbose: bool = C.QUANTIZE_VERBOSE_DEFAULT
    quantizer_kernel: bool = C.QUANTIZER_KERNEL_DEFAULT
    start_bits: int = C.QUANTIZE_START_BITS_DEFAULT
    target_bits: int = C.QUANTIZE_TARGET_BITS_DEFAULT
    quantize_period: int = C.QUANTIZE_PERIOD_DEFAULT
    schedule_offset: int = C.QUANTIZE_OFFSET_DEFAULT
    quantize_groups: int = C.QUANTIZE_GROUPS_DEFAULT
    quantize_type: int = C.QUANTIZE_TYPE_DEFAULT  # 0 symmetric / 1 asymmetric
    rounding: int = C.QUANTIZE_ROUNDING_DEFAULT  # 0 nearest / 1 stochastic
    fp16_mixed_quantize: bool = C.FP16_MIXED_QUANTIZE_ENABLED_DEFAULT
    quantize_change_ratio: float = C.QUANTIZE_CHANGE_RATIO_DEFAULT

    @staticmethod
    def from_dict(d: Optional[Dict[str, Any]]) -> "QuantizeTrainingConfig":
        d = d or {}
        bits = d.get(C.QUANTIZE_BITS, {})
        schedule = d.get(C.QUANTIZE_SCHEDULE, {})
        algo = d.get(C.QUANTIZE_ALGO, {})
        mixed = d.get(C.FP16_MIXED_QUANTIZE, {})
        qtype = algo.get(C.QUANTIZE_TYPE, C.QUANTIZE_SYMMETRIC)
        rounding = algo.get(C.QUANTIZE_ROUNDING, C.NEAREST_ROUNDING)
        return QuantizeTrainingConfig(
            enabled=get_scalar_param(d, C.QUANTIZE_TRAINING_ENABLED,
                                     C.QUANTIZE_TRAINING_ENABLED_DEFAULT),
            quantize_verbose=get_scalar_param(d, C.QUANTIZE_VERBOSE,
                                              C.QUANTIZE_VERBOSE_DEFAULT),
            quantizer_kernel=get_scalar_param(d, C.QUANTIZER_KERNEL,
                                              C.QUANTIZER_KERNEL_DEFAULT),
            start_bits=bits.get(C.START_BITS, C.QUANTIZE_START_BITS_DEFAULT),
            target_bits=bits.get(C.TARGET_BITS, C.QUANTIZE_TARGET_BITS_DEFAULT),
            quantize_period=schedule.get(C.QUANTIZE_PERIOD,
                                         C.QUANTIZE_PERIOD_DEFAULT),
            schedule_offset=schedule.get(C.SCHEDULE_OFFSET,
                                         C.QUANTIZE_OFFSET_DEFAULT),
            quantize_groups=get_scalar_param(d, C.QUANTIZE_GROUPS,
                                             C.QUANTIZE_GROUPS_DEFAULT),
            quantize_type=(0 if qtype == C.QUANTIZE_SYMMETRIC else 1),
            rounding=(1 if rounding == C.STOCHASTIC_ROUNDING else 0),
            fp16_mixed_quantize=mixed.get(C.FP16_MIXED_QUANTIZE_ENABLED,
                                          C.FP16_MIXED_QUANTIZE_ENABLED_DEFAULT),
            quantize_change_ratio=mixed.get(C.QUANTIZE_CHANGE_RATIO,
                                            C.QUANTIZE_CHANGE_RATIO_DEFAULT),
        )


@dataclass
class CheckpointConfig:
    tag_validation: str = C.CHECKPOINT_TAG_VALIDATION_DEFAULT
    # None = auto: sharded whenever multi-process (a consolidated save
    # would gather non-addressable arrays); True/False forces the layout.
    sharded: Optional[bool] = None

    @staticmethod
    def from_dict(d: Optional[Dict[str, Any]]) -> "CheckpointConfig":
        d = d or {}
        mode = get_scalar_param(d, C.CHECKPOINT_TAG_VALIDATION,
                                C.CHECKPOINT_TAG_VALIDATION_DEFAULT).upper()
        if mode not in C.CHECKPOINT_TAG_VALIDATION_MODES:
            raise DeepSpeedConfigError(
                "Checkpoint config {} only supports {}".format(
                    C.CHECKPOINT_TAG_VALIDATION, C.CHECKPOINT_TAG_VALIDATION_MODES))
        return CheckpointConfig(tag_validation=mode,
                                sharded=d.get("sharded"))


@dataclass
class PreemptionConfig:
    """SIGTERM/SIGINT → graceful stop at the next step boundary with an
    emergency checkpoint (TPU-native: preemptible pods)."""
    enabled: bool = C.PREEMPTION_ENABLED_DEFAULT
    signals: tuple = C.PREEMPTION_SIGNALS_DEFAULT
    emergency_tag_prefix: str = C.PREEMPTION_EMERGENCY_TAG_PREFIX_DEFAULT
    save_dir: Optional[str] = C.PREEMPTION_SAVE_DIR_DEFAULT
    reraise: bool = C.PREEMPTION_RERAISE_DEFAULT
    grace_s: float = C.PREEMPTION_GRACE_S_DEFAULT

    @staticmethod
    def from_dict(d: Optional[Dict[str, Any]]) -> "PreemptionConfig":
        d = d or {}
        signals = d.get(C.PREEMPTION_SIGNALS, C.PREEMPTION_SIGNALS_DEFAULT)
        if isinstance(signals, str):
            signals = [signals]  # a bare "SIGTERM" is not 7 signals
        import signal as _signal
        for name in signals:
            # membership in Signals, not hasattr: the signal module also
            # exposes non-signal attributes (SIG_DFL, SIG_IGN, ...) that
            # would install a handler on the wrong signal
            if not (isinstance(name, str)
                    and name in _signal.Signals.__members__):
                raise DeepSpeedConfigError(
                    f"resilience.preemption.signals entry {name!r} is not "
                    "a signal name (expected e.g. \"SIGTERM\", \"SIGINT\")")
        grace = float(get_scalar_param(d, C.PREEMPTION_GRACE_S,
                                       C.PREEMPTION_GRACE_S_DEFAULT))
        if grace < 0:
            raise DeepSpeedConfigError(
                f"resilience.preemption.grace_s must be >= 0, got {grace}")
        enabled = get_scalar_param(d, C.PREEMPTION_ENABLED,
                                   C.PREEMPTION_ENABLED_DEFAULT)
        if enabled and grace > 0:
            # The grace-deadline forced save runs on a single host's
            # timer thread; on a multi-process run it would write a
            # one-host checkpoint while the other hosts are mid-step —
            # never collective-consistent.  The config used to accept
            # this silently; fail loudly at parse time instead.
            import torch.distributed as dist
            nproc = (dist.get_world_size()
                     if dist.is_available() and dist.is_initialized() else 1)
            if nproc > 1:
                raise DeepSpeedConfigError(
                    "resilience.preemption.grace_s forced saves are "
                    "single-process only: the grace deadline fires on a "
                    "per-host timer thread and cannot coordinate a "
                    f"collective save across {nproc} processes. Set "
                    "grace_s to 0 on multihost and rely on the "
                    "step-boundary emergency save (the default "
                    "preemption path), which stops every host at the "
                    "same completed step.")
        return PreemptionConfig(
            enabled=enabled,
            signals=tuple(signals),
            emergency_tag_prefix=get_scalar_param(
                d, C.PREEMPTION_EMERGENCY_TAG_PREFIX,
                C.PREEMPTION_EMERGENCY_TAG_PREFIX_DEFAULT),
            save_dir=get_scalar_param(d, C.PREEMPTION_SAVE_DIR,
                                      C.PREEMPTION_SAVE_DIR_DEFAULT),
            reraise=get_scalar_param(d, C.PREEMPTION_RERAISE,
                                     C.PREEMPTION_RERAISE_DEFAULT),
            grace_s=grace,
        )


@dataclass
class SentinelConfig:
    """On-device training-health monitor: EWMA of loss + global grad-norm,
    NaN/Inf and k-sigma spike detection — catches bf16 blow-ups the fp16
    overflow skip never sees."""
    enabled: bool = C.SENTINEL_ENABLED_DEFAULT
    ewma_alpha: float = C.SENTINEL_EWMA_ALPHA_DEFAULT
    k_sigma: float = C.SENTINEL_K_SIGMA_DEFAULT
    warmup_steps: int = C.SENTINEL_WARMUP_STEPS_DEFAULT
    policy: str = C.SENTINEL_POLICY_DEFAULT
    anomaly_budget: int = C.SENTINEL_ANOMALY_BUDGET_DEFAULT
    monitor_grad_norm: bool = C.SENTINEL_MONITOR_GRAD_NORM_DEFAULT

    @staticmethod
    def from_dict(d: Optional[Dict[str, Any]]) -> "SentinelConfig":
        d = d or {}
        cfg = SentinelConfig(
            enabled=get_scalar_param(d, C.SENTINEL_ENABLED,
                                     C.SENTINEL_ENABLED_DEFAULT),
            ewma_alpha=float(get_scalar_param(
                d, C.SENTINEL_EWMA_ALPHA, C.SENTINEL_EWMA_ALPHA_DEFAULT)),
            k_sigma=float(get_scalar_param(d, C.SENTINEL_K_SIGMA,
                                           C.SENTINEL_K_SIGMA_DEFAULT)),
            warmup_steps=int(get_scalar_param(
                d, C.SENTINEL_WARMUP_STEPS, C.SENTINEL_WARMUP_STEPS_DEFAULT)),
            policy=get_scalar_param(d, C.SENTINEL_POLICY,
                                    C.SENTINEL_POLICY_DEFAULT),
            anomaly_budget=int(get_scalar_param(
                d, C.SENTINEL_ANOMALY_BUDGET,
                C.SENTINEL_ANOMALY_BUDGET_DEFAULT)),
            monitor_grad_norm=get_scalar_param(
                d, C.SENTINEL_MONITOR_GRAD_NORM,
                C.SENTINEL_MONITOR_GRAD_NORM_DEFAULT),
        )
        if cfg.policy not in C.SENTINEL_POLICIES:
            raise DeepSpeedConfigError(
                f"resilience.sentinel.policy={cfg.policy!r} — supported "
                f"policies are {list(C.SENTINEL_POLICIES)}")
        if not 0.0 < cfg.ewma_alpha <= 1.0:
            raise DeepSpeedConfigError(
                "resilience.sentinel.ewma_alpha must be in (0, 1], got "
                f"{cfg.ewma_alpha}")
        if cfg.anomaly_budget < 1:
            raise DeepSpeedConfigError(
                "resilience.sentinel.anomaly_budget must be >= 1, got "
                f"{cfg.anomaly_budget}")
        return cfg


@dataclass
class ChaosConfig:
    """Deterministic fault-injection plane (resilience/chaos.py) — off
    by default.  ``faults`` is a tuple of fault-spec dicts, each
    validated at parse time against the injection-point catalog: a
    typo'd point or a kind that makes no sense at that surface fails
    here, not by silently never firing."""
    enabled: bool = C.CHAOS_ENABLED_DEFAULT
    seed: int = C.CHAOS_SEED_DEFAULT
    faults: tuple = C.CHAOS_FAULTS_DEFAULT

    @staticmethod
    def from_dict(d: Optional[Dict[str, Any]]) -> "ChaosConfig":
        d = d or {}
        faults = d.get(C.CHAOS_FAULTS, C.CHAOS_FAULTS_DEFAULT)
        if isinstance(faults, dict):
            faults = [faults]
        try:
            faults = tuple(faults)
        except TypeError:
            raise DeepSpeedConfigError(
                "resilience.chaos.faults must be a list of fault specs "
                f"(dicts), got {faults!r}")
        cfg = ChaosConfig(
            enabled=bool(get_scalar_param(d, C.CHAOS_ENABLED,
                                          C.CHAOS_ENABLED_DEFAULT)),
            seed=int(get_scalar_param(d, C.CHAOS_SEED,
                                      C.CHAOS_SEED_DEFAULT)),
            faults=faults,
        )
        # the JAX package also validates every spec against its fault
        # catalog (runtime/resilience/chaos.py), which the port has not
        # ported yet (ROADMAP.md A.13)
        for spec in cfg.faults:
            if not isinstance(spec, dict):
                raise DeepSpeedConfigError(
                    "resilience.chaos.faults entries must be dicts "
                    f"(point/kind/trigger), got {spec!r}")
        return cfg


@dataclass
class ResilienceConfig:
    """Fault-tolerance block (all off by default — the engine is
    byte-identical to the pre-resilience behavior when disabled, except
    the always-on atomic `latest` rename bugfix)."""
    enabled: bool = C.RESILIENCE_ENABLED_DEFAULT
    atomic_checkpoints: bool = C.RESILIENCE_ATOMIC_CHECKPOINTS_DEFAULT
    verify_on_load: bool = C.RESILIENCE_VERIFY_ON_LOAD_DEFAULT
    max_fallback_tags: int = C.RESILIENCE_MAX_FALLBACK_TAGS_DEFAULT
    keep_last_n: int = C.RESILIENCE_KEEP_LAST_N_DEFAULT
    keep_every: int = C.RESILIENCE_KEEP_EVERY_DEFAULT
    io_retries: int = C.RESILIENCE_IO_RETRIES_DEFAULT
    io_backoff_seconds: float = C.RESILIENCE_IO_BACKOFF_SECONDS_DEFAULT
    retry_jitter: float = C.RESILIENCE_RETRY_JITTER_DEFAULT
    retry_seed: int = C.RESILIENCE_RETRY_SEED_DEFAULT
    retry_max_backoff_seconds: float = (
        C.RESILIENCE_RETRY_MAX_BACKOFF_SECONDS_DEFAULT)
    verify_lockstep_on_resume: bool = (
        C.RESILIENCE_VERIFY_LOCKSTEP_ON_RESUME_DEFAULT)
    preemption: PreemptionConfig = field(default_factory=PreemptionConfig)
    sentinel: SentinelConfig = field(default_factory=SentinelConfig)
    chaos: ChaosConfig = field(default_factory=ChaosConfig)

    @property
    def atomic_enabled(self) -> bool:
        return self.enabled and self.atomic_checkpoints

    @property
    def verify_enabled(self) -> bool:
        return self.enabled and self.verify_on_load

    @property
    def gc_enabled(self) -> bool:
        return self.enabled and self.keep_last_n > 0

    @property
    def lockstep_resume_enabled(self) -> bool:
        return self.enabled and self.verify_lockstep_on_resume

    @staticmethod
    def from_dict(d: Optional[Dict[str, Any]]) -> "ResilienceConfig":
        d = d or {}
        cfg = ResilienceConfig(
            enabled=get_scalar_param(d, C.RESILIENCE_ENABLED,
                                     C.RESILIENCE_ENABLED_DEFAULT),
            atomic_checkpoints=get_scalar_param(
                d, C.RESILIENCE_ATOMIC_CHECKPOINTS,
                C.RESILIENCE_ATOMIC_CHECKPOINTS_DEFAULT),
            verify_on_load=get_scalar_param(
                d, C.RESILIENCE_VERIFY_ON_LOAD,
                C.RESILIENCE_VERIFY_ON_LOAD_DEFAULT),
            max_fallback_tags=int(get_scalar_param(
                d, C.RESILIENCE_MAX_FALLBACK_TAGS,
                C.RESILIENCE_MAX_FALLBACK_TAGS_DEFAULT)),
            keep_last_n=int(get_scalar_param(
                d, C.RESILIENCE_KEEP_LAST_N,
                C.RESILIENCE_KEEP_LAST_N_DEFAULT)),
            keep_every=int(get_scalar_param(
                d, C.RESILIENCE_KEEP_EVERY, C.RESILIENCE_KEEP_EVERY_DEFAULT)),
            io_retries=int(get_scalar_param(
                d, C.RESILIENCE_IO_RETRIES, C.RESILIENCE_IO_RETRIES_DEFAULT)),
            io_backoff_seconds=float(get_scalar_param(
                d, C.RESILIENCE_IO_BACKOFF_SECONDS,
                C.RESILIENCE_IO_BACKOFF_SECONDS_DEFAULT)),
            retry_jitter=float(get_scalar_param(
                d, C.RESILIENCE_RETRY_JITTER,
                C.RESILIENCE_RETRY_JITTER_DEFAULT)),
            retry_seed=int(get_scalar_param(
                d, C.RESILIENCE_RETRY_SEED,
                C.RESILIENCE_RETRY_SEED_DEFAULT)),
            retry_max_backoff_seconds=float(get_scalar_param(
                d, C.RESILIENCE_RETRY_MAX_BACKOFF_SECONDS,
                C.RESILIENCE_RETRY_MAX_BACKOFF_SECONDS_DEFAULT)),
            verify_lockstep_on_resume=get_scalar_param(
                d, C.RESILIENCE_VERIFY_LOCKSTEP_ON_RESUME,
                C.RESILIENCE_VERIFY_LOCKSTEP_ON_RESUME_DEFAULT),
            preemption=PreemptionConfig.from_dict(
                d.get(C.RESILIENCE_PREEMPTION)),
            sentinel=SentinelConfig.from_dict(d.get(C.RESILIENCE_SENTINEL)),
            chaos=ChaosConfig.from_dict(d.get(C.RESILIENCE_CHAOS)),
        )
        if cfg.keep_last_n < 0 or cfg.keep_every < 0:
            raise DeepSpeedConfigError(
                "resilience.keep_last_n / keep_every must be >= 0, got "
                f"{cfg.keep_last_n} / {cfg.keep_every}")
        if cfg.io_retries < 0:
            raise DeepSpeedConfigError(
                f"resilience.io_retries must be >= 0, got {cfg.io_retries}")
        if cfg.retry_jitter < 0:
            raise DeepSpeedConfigError(
                f"resilience.retry_jitter must be >= 0, got "
                f"{cfg.retry_jitter}")
        if cfg.retry_max_backoff_seconds <= 0:
            raise DeepSpeedConfigError(
                "resilience.retry_max_backoff_seconds must be > 0, got "
                f"{cfg.retry_max_backoff_seconds}")
        return cfg

    def build_retry_policy(self, sleep=None):
        """The shared RetryPolicy for NVMe swap I/O and checkpoint
        staging, or None when resilience is off / retries are 0."""
        if not self.enabled or self.io_retries <= 0:
            return None
        from .runtime.resilience.retry import RetryPolicy
        return RetryPolicy(retries=self.io_retries,
                           backoff_s=self.io_backoff_seconds,
                           max_backoff_s=self.retry_max_backoff_seconds,
                           jitter=self.retry_jitter,
                           seed=self.retry_seed, sleep=sleep)


@dataclass
class MeshConfig:
    """TPU-native: named-axis device mesh shape.  -1 means "fill with the
    remaining devices" (like a reshape wildcard); exactly one axis may be -1.
    Axis order is ICI-aware: data outermost, model innermost so tensor-parallel
    collectives ride the fastest links."""
    data: int = -1
    model: int = 1
    pipe: int = 1
    expert: int = 1
    seq: int = 1

    @staticmethod
    def from_dict(d: Optional[Dict[str, Any]]) -> "MeshConfig":
        d = d or {}
        return MeshConfig(
            data=int(d.get(C.MESH_DATA_AXIS, -1)),
            model=int(d.get(C.MESH_MODEL_AXIS, 1)),
            pipe=int(d.get(C.MESH_PIPE_AXIS, 1)),
            expert=int(d.get(C.MESH_EXPERT_AXIS, 1)),
            seq=int(d.get(C.MESH_SEQ_AXIS, 1)),
        )


@dataclass
class SequenceParallelConfig:
    """TPU-native long-context layer (ring attention / Ulysses)."""
    mode: str = C.SEQUENCE_PARALLEL_MODE_DEFAULT
    size: int = C.SEQUENCE_PARALLEL_SIZE_DEFAULT

    @staticmethod
    def from_dict(d: Optional[Dict[str, Any]]) -> "SequenceParallelConfig":
        d = d or {}
        return SequenceParallelConfig(
            mode=get_scalar_param(d, C.SEQUENCE_PARALLEL_MODE,
                                  C.SEQUENCE_PARALLEL_MODE_DEFAULT),
            size=int(get_scalar_param(d, C.SEQUENCE_PARALLEL_SIZE,
                                      C.SEQUENCE_PARALLEL_SIZE_DEFAULT)),
        )


class DeepSpeedConfig:
    """Parse a DeepSpeed-style JSON config (path or dict) into typed configs.

    Reference semantics: deepspeed/runtime/config.py:682.  `world_size` here is
    the data-parallel world size used in the batch triple inference
    (reference: config.py:869 train_batch = micro_batch × gas × dp_world).
    """

    def __init__(self, config, world_size: int = 1, elastic_resolver=None):
        self._param_dict = load_config_dict(config)
        self.world_size = world_size

        # Elasticity may rewrite the batch keys before inference
        # (reference: runtime/config.py:707-757).
        self.elasticity_enabled = False
        elastic_dict = self._param_dict.get(C.ELASTICITY)
        if elastic_dict and get_scalar_param(elastic_dict, C.ENABLED,
                                             C.ENABLED_DEFAULT):
            self.elasticity_enabled = True
            from .elasticity import apply_elasticity
            apply_elasticity(self._param_dict, world_size)

        self._initialize_params(self._param_dict)
        self._batch_assertion()

    # ------------------------------------------------------------------ #
    def _initialize_params(self, pd: Dict[str, Any]) -> None:
        self.train_batch_size = get_scalar_param(pd, C.TRAIN_BATCH_SIZE,
                                                 C.TRAIN_BATCH_SIZE_DEFAULT)
        self.train_micro_batch_size_per_gpu = get_scalar_param(
            pd, C.TRAIN_MICRO_BATCH_SIZE_PER_GPU,
            C.TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT)
        self.gradient_accumulation_steps = get_scalar_param(
            pd, C.GRADIENT_ACCUMULATION_STEPS,
            C.GRADIENT_ACCUMULATION_STEPS_DEFAULT)
        self._infer_batch_params()

        self.steps_per_print = get_scalar_param(pd, C.STEPS_PER_PRINT,
                                                C.STEPS_PER_PRINT_DEFAULT)
        self.dump_state = get_scalar_param(pd, C.DUMP_STATE,
                                           C.DUMP_STATE_DEFAULT)
        self.prng_impl = get_scalar_param(pd, C.PRNG_IMPL,
                                          C.PRNG_IMPL_DEFAULT)
        self.gradient_clipping = get_scalar_param(pd, C.GRADIENT_CLIPPING,
                                                  C.GRADIENT_CLIPPING_DEFAULT)
        self.sparse_gradients_enabled = get_scalar_param(
            pd, C.SPARSE_GRADIENTS, C.SPARSE_GRADIENTS_DEFAULT)
        self.prescale_gradients = get_scalar_param(pd, C.PRESCALE_GRADIENTS,
                                                   C.PRESCALE_GRADIENTS_DEFAULT)
        self.gradient_predivide_factor = get_scalar_param(
            pd, C.GRADIENT_PREDIVIDE_FACTOR, C.GRADIENT_PREDIVIDE_FACTOR_DEFAULT)
        self.fp32_allreduce = get_scalar_param(pd, C.FP32_ALLREDUCE,
                                               C.FP32_ALLREDUCE_DEFAULT)
        self.disable_allgather = get_scalar_param(pd, C.DISABLE_ALLGATHER,
                                                  C.DISABLE_ALLGATHER_DEFAULT)
        self.wall_clock_breakdown = get_scalar_param(
            pd, C.WALL_CLOCK_BREAKDOWN, C.WALL_CLOCK_BREAKDOWN_DEFAULT)
        self.memory_breakdown = get_scalar_param(pd, C.MEMORY_BREAKDOWN,
                                                 C.MEMORY_BREAKDOWN_DEFAULT)
        self.zero_allow_untested_optimizer = get_scalar_param(
            pd, C.ZERO_ALLOW_UNTESTED_OPTIMIZER,
            C.ZERO_ALLOW_UNTESTED_OPTIMIZER_DEFAULT)

        opt = pd.get(C.OPTIMIZER)
        self.optimizer_name = (opt.get(C.TYPE).lower()
                               if opt and opt.get(C.TYPE) else None)
        self.optimizer_params = opt.get(C.OPTIMIZER_PARAMS, {}) if opt else {}
        self.optimizer_legacy_fusion = (opt.get(C.LEGACY_FUSION,
                                                C.LEGACY_FUSION_DEFAULT)
                                        if opt else C.LEGACY_FUSION_DEFAULT)

        sched = pd.get(C.SCHEDULER)
        self.scheduler_name = sched.get(C.TYPE) if sched else None
        self.scheduler_params = sched.get(C.SCHEDULER_PARAMS, {}) if sched else {}

        self.fp16 = FP16Config.from_dict(pd.get(C.FP16))
        self.bf16 = BF16Config.from_dict(pd.get(C.BF16))
        self.amp = pd.get(C.AMP, {})
        self.amp_enabled = self.amp.get(C.AMP_ENABLED, C.AMP_ENABLED_DEFAULT)

        self.zero_config = ZeroConfig.from_dict(pd.get(C.ZERO_OPTIMIZATION))
        self.aio_config = AioConfig.from_dict(pd.get(C.AIO))
        self.activation_checkpointing_config = (
            ActivationCheckpointingConfig.from_dict(
                pd.get(C.ACTIVATION_CHECKPOINTING)))
        self.flops_profiler_config = FlopsProfilerConfig.from_dict(
            pd.get(C.FLOPS_PROFILER))
        self.tensorboard_config = TensorboardConfig.from_dict(
            pd.get(C.TENSORBOARD))
        self.fused_step_config = FusedStepConfig.from_dict(
            pd.get(C.FUSED_STEP))
        self.analysis_config = AnalysisConfig.from_dict(pd.get(C.ANALYSIS))
        self.autotuning_config = AutotuningConfig.from_dict(
            pd.get(C.AUTOTUNING))
        self.monitor_config = MonitorConfig.from_dict(pd.get(C.MONITOR))
        self.eigenvalue_config = EigenvalueConfig.from_dict(pd.get(C.EIGENVALUE))
        self.pld_config = PLDConfig.from_dict(pd.get(C.PROGRESSIVE_LAYER_DROP))
        self.curriculum_config = CurriculumConfig.from_dict(
            pd.get(C.CURRICULUM_LEARNING))
        self.quantize_training_config = QuantizeTrainingConfig.from_dict(
            pd.get(C.QUANTIZE_TRAINING))
        self.checkpoint_config = CheckpointConfig.from_dict(pd.get(C.CHECKPOINT))
        self.resilience_config = ResilienceConfig.from_dict(
            pd.get(C.RESILIENCE))
        self.sparse_attention = pd.get(C.SPARSE_ATTENTION)
        self.mesh_config = MeshConfig.from_dict(pd.get(C.MESH))
        self.sequence_parallel_config = SequenceParallelConfig.from_dict(
            pd.get(C.SEQUENCE_PARALLEL))
        self.pipeline = pd.get(C.PIPELINE, {})
        self.vocabulary_size = get_scalar_param(pd, C.VOCABULARY_SIZE,
                                                C.VOCABULARY_SIZE_DEFAULT)
        self._validate_onebit()

    # ------------------------------------------------------------------ #
    def _validate_onebit(self) -> None:
        """1-bit optimizer tier cross-field validation (docs/onebit.md).

        Two layers: the onebit optimizers' params block is validated
        whenever a OneBitAdam/OneBitLamb optimizer is named, and the
        wire tier (`zero_optimization.low_bandwidth.onebit`) is checked
        against every feature it cannot compose with — each conflict is
        a loud DeepSpeedConfigError naming the offending knob, never a
        silent numerics-only fallback."""
        # spellings owned by runtime/optimizers.py (lowered there too)
        onebit_names = ("onebitadam", "onebitlamb")
        is_onebit_opt = self.optimizer_name in onebit_names
        if is_onebit_opt:
            freeze = self.optimizer_params.get("freeze_step", 100)
            if not isinstance(freeze, int) or freeze < 1:
                raise DeepSpeedConfigError(
                    f"optimizer.params.freeze_step must be an int >= 1 "
                    f"for {self.optimizer_name}, got {freeze!r}")
            betas = self.optimizer_params.get("betas", (0.9, 0.999))
            if (len(tuple(betas)) != 2
                    or not all(0.0 <= float(b) < 1.0 for b in betas)):
                raise DeepSpeedConfigError(
                    f"optimizer.params.betas for {self.optimizer_name} "
                    f"must be two floats in [0, 1), got {betas!r}")
        lb = self.zero_config.low_bandwidth
        if not lb.onebit:
            return
        prefix = (f"zero_optimization.low_bandwidth."
                  f"{C.LOW_BANDWIDTH_ONEBIT}=true conflicts with ")
        if not is_onebit_opt:
            raise DeepSpeedConfigError(
                f"zero_optimization.low_bandwidth.{C.LOW_BANDWIDTH_ONEBIT}"
                f"=true requires a OneBitAdam or OneBitLamb optimizer "
                f"(the wire format is the optimizer's error-feedback "
                f"momentum), got optimizer.type="
                f"{self.optimizer_name!r}")
        if self.zero_config.stage >= 3:
            raise DeepSpeedConfigError(
                prefix + f"zero_optimization.stage="
                f"{self.zero_config.stage}: the ZeRO-3 streaming path "
                "gathers params/scatters grads inside the step program "
                "and has no whole-gradient allreduce to replace — use "
                "stage <= 2")
        if self.zero_config.offload_optimizer is not None:
            raise DeepSpeedConfigError(
                prefix + "zero_optimization.offload_optimizer: the "
                "compressed phase keeps momentum (and its error "
                "feedback) device-resident and replicated; an offloaded "
                "optimizer state cannot host the packed momentum sync")
        if self.sparse_gradients_enabled:
            raise DeepSpeedConfigError(
                prefix + "sparse_gradients: both features rewrite the "
                "data-parallel gradient reduction and cannot stack")
        if self.gradient_clipping and self.gradient_clipping > 0:
            raise DeepSpeedConfigError(
                prefix + f"gradient_clipping={self.gradient_clipping}: "
                "global-norm clipping needs the dense gradient on every "
                "worker before the optimizer sees it, which is exactly "
                "the allreduce the 1-bit tier removes")

    # ------------------------------------------------------------------ #
    @property
    def zero_enabled(self) -> bool:
        return self.zero_config.stage > 0

    @property
    def zero_optimization_stage(self) -> int:
        return self.zero_config.stage

    @property
    def quantize_training_enabled(self) -> bool:
        return self.quantize_training_config.enabled

    @property
    def pld_enabled(self) -> bool:
        return self.pld_config.enabled

    @property
    def curriculum_enabled(self) -> bool:
        return self.curriculum_config.enabled

    # ------------------------------------------------------------------ #
    def _infer_batch_params(self) -> None:
        """Resolve (train_batch, micro_batch, gas) given any subset
        (reference: config.py:874-924)."""
        train = self.train_batch_size
        micro = self.train_micro_batch_size_per_gpu
        gas = self.gradient_accumulation_steps
        ws = self.world_size

        if train is not None and micro is not None and gas is not None:
            pass
        elif train is not None and micro is not None:
            gas = train // (micro * ws)
        elif train is not None and gas is not None:
            micro = train // (ws * gas)
        elif micro is not None and gas is not None:
            train = micro * gas * ws
        elif train is not None:
            gas = 1
            micro = train // ws
        elif micro is not None:
            train = micro * ws
            gas = 1
        else:
            raise DeepSpeedConfigError(
                "Either train_batch_size or train_micro_batch_size_per_gpu "
                "needs to be provided")

        self.train_batch_size = train
        self.train_micro_batch_size_per_gpu = micro
        self.gradient_accumulation_steps = gas

    def _batch_assertion(self) -> None:
        train = self.train_batch_size
        micro = self.train_micro_batch_size_per_gpu
        gas = self.gradient_accumulation_steps
        ws = self.world_size
        if train <= 0:
            raise DeepSpeedConfigError(
                f"Train batch size: {train} has to be greater than 0")
        if micro <= 0:
            raise DeepSpeedConfigError(
                f"Micro batch size per gpu: {micro} has to be greater than 0")
        if gas <= 0:
            raise DeepSpeedConfigError(
                f"Gradient accumulation steps: {gas} has to be greater than 0")
        if train != micro * gas * ws:
            raise DeepSpeedConfigError(
                f"Check batch related parameters. train_batch_size is not equal"
                f" to micro_batch_per_gpu * gradient_acc_step * world_size "
                f"{train} != {micro} * {gas} * {ws}")

    def print_config(self, logger_fn=print) -> None:
        logger_fn("DeepSpeedConfig:")
        for k, v in sorted(self.__dict__.items()):
            if k == "_param_dict":
                continue
            logger_fn("  {:40s} {}".format(k, v))
