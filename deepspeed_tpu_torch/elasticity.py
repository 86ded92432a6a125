"""Elastic batch-size solver.

Pre-computes a (total_batch_size, micro_batch, valid-chip-count set) that stays
consistent as the job is resized between min and max chips, so hyperparameters
survive a scheduler resize.  Reference: deepspeed/elasticity/elasticity.py
(candidate enumeration :21-75, compute_elastic_config :226); this is a pure-math
re-implementation — no torch, no CUDA.

A copy of deepspeed_tpu/elasticity.py without its command line, which
the config copy needs to parse an elasticity block.  The port keeps its own copy (ROADMAP.md A.2): the JAX package's module
is jax-free, but importing it runs deepspeed_tpu/__init__.py, which
imports JAX.
"""

from typing import Dict, List, Tuple

from . import constants as C


class ElasticityError(Exception):
    pass


class ElasticityConfigError(ElasticityError):
    pass


class ElasticityIncompatibleWorldSize(ElasticityError):
    pass


class ElasticityConfig:
    """Typed view of the "elasticity" config block
    (reference: deepspeed/elasticity/config.py:30)."""

    def __init__(self, param_dict: Dict):
        self.enabled = param_dict.get(C.ENABLED, C.ENABLED_DEFAULT)
        if C.MAX_ACCEPTABLE_BATCH_SIZE not in param_dict:
            raise ElasticityConfigError(
                f"Elasticity config missing {C.MAX_ACCEPTABLE_BATCH_SIZE}")
        self.max_acceptable_batch_size = param_dict[C.MAX_ACCEPTABLE_BATCH_SIZE]
        if C.MICRO_BATCHES not in param_dict:
            raise ElasticityConfigError(
                f"Elasticity config missing {C.MICRO_BATCHES}")
        self.micro_batches = param_dict[C.MICRO_BATCHES]
        if not isinstance(self.micro_batches, list) or not all(
                isinstance(m, int) and m > 0 for m in self.micro_batches):
            raise ElasticityConfigError(
                f"Elasticity expected positive int list of micro batches, "
                f"instead saw: {self.micro_batches}")
        self.min_gpus = param_dict.get(C.MIN_GPUS, C.MIN_GPUS_DEFAULT)
        self.max_gpus = param_dict.get(C.MAX_GPUS, C.MAX_GPUS_DEFAULT)
        if self.min_gpus < 1 or self.max_gpus < 1 or self.max_gpus < self.min_gpus:
            raise ElasticityConfigError("Invalid min/max chips in elasticity config")
        self.min_time = param_dict.get(C.MIN_TIME, C.MIN_TIME_DEFAULT)
        self.version = param_dict.get(C.VERSION, C.VERSION_DEFAULT)
        self.prefer_larger_batch_size = param_dict.get(
            C.PREFER_LARGER_BATCH, C.PREFER_LARGER_BATCH_DEFAULT)
        self.ignore_non_elastic_batch_info = param_dict.get(
            C.IGNORE_NON_ELASTIC_BATCH_INFO,
            C.IGNORE_NON_ELASTIC_BATCH_INFO_DEFAULT)


# Multipliers with many divisors (highly-composite-style), so candidate batch
# sizes are divisible by many chip counts (reference: elasticity.py HCN_LIST).
_COMPOSITE_MULTIPLIERS = [
    1, 2, 4, 6, 12, 24, 36, 48, 60, 120, 180, 240, 360, 720, 840, 1080, 1260,
    1680, 2520, 5040, 7560, 10080
]


def get_candidate_batch_sizes(micro_batches: List[int],
                              max_acceptable_batch_size: int) -> List[int]:
    candidates = set()
    for mb in micro_batches:
        for mult in _COMPOSITE_MULTIPLIERS:
            batch = mb * mult
            if batch <= max_acceptable_batch_size:
                candidates.add(batch)
    return sorted(candidates)


def get_valid_gpus(batch_size: int, micro_batches: List[int], min_valid_gpus: int,
                   max_valid_gpus: int) -> List[int]:
    valid = set()
    for mb in micro_batches:
        if batch_size % mb != 0:
            continue
        max_gpus_for_mb = batch_size // mb
        for g in range(1, max_gpus_for_mb + 1):
            if max_gpus_for_mb % g == 0 and min_valid_gpus <= g <= max_valid_gpus:
                valid.add(g)
    return sorted(valid)


def get_best_candidates(candidate_batch_sizes: List[int], micro_batches: List[int],
                        min_gpus: int, max_gpus: int,
                        prefer_larger: bool) -> Tuple[int, List[int]]:
    max_valid_count = -1
    best_batch = -1
    best_gpus = []
    for batch in candidate_batch_sizes:
        valid = get_valid_gpus(batch, micro_batches, min_gpus, max_gpus)
        better = len(valid) > max_valid_count
        tie = len(valid) == max_valid_count and prefer_larger and batch > best_batch
        if better or tie:
            max_valid_count = len(valid)
            best_batch = batch
            best_gpus = valid
    if best_batch < 0:
        raise ElasticityError(
            "Unable to find a compatible batch size within the elastic bounds")
    return best_batch, best_gpus


def _get_compatible_micro_batch(final_batch_size: int, micro_batches: List[int],
                                world_size: int,
                                prefer_larger: bool) -> int:
    if final_batch_size % world_size != 0:
        raise ElasticityIncompatibleWorldSize(
            f"World size {world_size} is not valid for final batch size "
            f"{final_batch_size}")
    per_gpu = final_batch_size // world_size
    candidates = [mb for mb in micro_batches if per_gpu % mb == 0]
    if not candidates:
        raise ElasticityIncompatibleWorldSize(
            f"No micro batch in {micro_batches} divides per-chip batch {per_gpu}")
    return max(candidates) if prefer_larger else min(candidates)


def nearest_valid_world_sizes(valid_gpus: List[int], world_size: int,
                              k: int = 3) -> List[int]:
    """The `k` valid chip counts closest to `world_size` (ties resolve
    smaller-first) — what an incompatible-world-size error suggests, and
    what the fleet supervisor shrinks/regrows toward."""
    return sorted(valid_gpus,
                  key=lambda g: (abs(g - world_size), g))[:k]


def _incompatible_world_size_error(world_size: int, final_batch_size: int,
                                   valid_gpus: List[int],
                                   micro_batches: List[int],
                                   prefer_larger: bool
                                   ) -> "ElasticityIncompatibleWorldSize":
    """An ACTIONABLE incompatible-world-size error: names the nearest
    valid world sizes and the micro-batch/gas each would run with, so an
    operator (or the fleet supervisor) can pick a target instead of
    bisecting chip counts against a bare exception."""
    suggestions = []
    for g in nearest_valid_world_sizes(valid_gpus, world_size):
        micro = _get_compatible_micro_batch(final_batch_size, micro_batches,
                                            g, prefer_larger)
        suggestions.append(
            f"{g} chips (micro_batch={micro}, "
            f"gas={final_batch_size // (micro * g)})")
    return ElasticityIncompatibleWorldSize(
        f"World size ({world_size}) is not valid with the current list "
        f"of valid chip counts: {valid_gpus} "
        f"(final batch size {final_batch_size}). Nearest valid world "
        f"sizes: {'; '.join(suggestions) or 'none'} — resize the job to "
        "one of these, or widen elasticity.micro_batch_sizes / "
        "min_gpus / max_gpus to admit the current size.")


def compute_elastic_config(ds_config: Dict, world_size: int = 0):
    """Returns (final_batch_size, valid_gpus[, micro_batch_per_gpu]).

    Reference: deepspeed/elasticity/elasticity.py:226.
    """
    elastic_config = ElasticityConfig(ds_config[C.ELASTICITY])
    if float(elastic_config.version) > C.LATEST_ELASTICITY_VERSION:
        raise ElasticityConfigError(
            f"Unsupported elasticity version {elastic_config.version}")
    candidates = get_candidate_batch_sizes(
        elastic_config.micro_batches, elastic_config.max_acceptable_batch_size)
    final_batch_size, valid_gpus = get_best_candidates(
        candidates, elastic_config.micro_batches, elastic_config.min_gpus,
        elastic_config.max_gpus, elastic_config.prefer_larger_batch_size)
    if world_size > 0:
        if world_size not in valid_gpus:
            raise _incompatible_world_size_error(
                world_size, final_batch_size, valid_gpus,
                elastic_config.micro_batches,
                elastic_config.prefer_larger_batch_size)
        micro = _get_compatible_micro_batch(
            final_batch_size, elastic_config.micro_batches, world_size,
            elastic_config.prefer_larger_batch_size)
        return final_batch_size, valid_gpus, micro
    return final_batch_size, valid_gpus


def apply_elasticity(param_dict: Dict, world_size: int) -> None:
    """Rewrite the batch keys in-place (reference: runtime/config.py:707-757)."""
    elastic_dict = param_dict[C.ELASTICITY]
    ignore = elastic_dict.get(C.IGNORE_NON_ELASTIC_BATCH_INFO,
                              C.IGNORE_NON_ELASTIC_BATCH_INFO_DEFAULT)
    if not ignore:
        for key in (C.TRAIN_BATCH_SIZE, C.TRAIN_MICRO_BATCH_SIZE_PER_GPU,
                    C.GRADIENT_ACCUMULATION_STEPS):
            if key in param_dict:
                raise ElasticityConfigError(
                    f"Elasticity is enabled, but config still contains {key}; "
                    f"remove it or set {C.IGNORE_NON_ELASTIC_BATCH_INFO}")
    final_batch_size, _, micro = compute_elastic_config(param_dict,
                                                        world_size=world_size)
    gas = final_batch_size // (micro * world_size)
    param_dict[C.TRAIN_BATCH_SIZE] = final_batch_size
    param_dict[C.TRAIN_MICRO_BATCH_SIZE_PER_GPU] = micro
    param_dict[C.GRADIENT_ACCUMULATION_STEPS] = gas
