"""Data loading (counterpart of deepspeed_tpu/runtime/dataloader.py).

The loader yields numpy batches, strided over data-parallel ranks like a
DistributedSampler; the engine moves each batch to its device.
`stack_microbatches` stacks a window's micro-batches for the fused
whole-step path (runtime/fused_step.py), as in the JAX package.
"""

import math
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np
import torch


def _default_collate(samples):
    first = samples[0]
    if isinstance(first, (tuple, list)):
        return type(first)(
            _default_collate([s[i] for s in samples])
            for i in range(len(first)))
    if isinstance(first, dict):
        return {k: _default_collate([s[k] for s in samples]) for k in first}
    return np.stack([np.asarray(s) for s in samples])


class DeepSpeedDataLoader:
    """Batches an indexable dataset for one data-parallel rank set.

    Args mirror the reference loader: dataset, batch_size (per pass through
    this loader, i.e. micro_batch × dp_world for the global loader),
    collate_fn, plus rank/world selection for multi-host.
    """

    def __init__(self, dataset, batch_size: int,
                 collate_fn: Optional[Callable] = None,
                 local_rank: int = 0, data_parallel_world_size: int = 1,
                 data_parallel_rank: int = 0, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.collate_fn = collate_fn or _default_collate
        self.dp_world = max(1, data_parallel_world_size)
        self.dp_rank = data_parallel_rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        n = len(dataset)
        per_rank = n // self.dp_world if drop_last else math.ceil(n / self.dp_world)
        self.len = per_rank // self.batch_size if drop_last else math.ceil(
            per_rank / self.batch_size)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return self.len

    def __iter__(self) -> Iterator[Any]:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(idx)
        # strided rank selection, like DistributedSampler
        idx = idx[self.dp_rank::self.dp_world]
        usable = (len(idx) // self.batch_size) * self.batch_size \
            if self.drop_last else len(idx)
        for start in range(0, usable, self.batch_size):
            chunk = idx[start:start + self.batch_size]
            samples = [self.dataset[int(i)] for i in chunk]
            yield self.collate_fn(samples)


def _treedef(tree) -> str:
    """The structure of a batch as JAX prints a PyTreeDef's body: tuples
    `(*, *)`, lists `[*, *]`, dicts `{'k': *}` by sorted key, None as
    `None`, every other value a leaf `*`."""
    if tree is None:
        return "None"
    if isinstance(tree, tuple):
        inner = ", ".join(_treedef(t) for t in tree)
        return f"({inner},)" if len(tree) == 1 else f"({inner})"
    if isinstance(tree, list):
        return "[" + ", ".join(_treedef(t) for t in tree) + "]"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    return "*"


def _leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _leaves(t)]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


def _rebuild(tree, leaves):
    """`tree`'s structure over the leaves of the iterator `leaves`."""
    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(t, leaves) for t in tree)
    if isinstance(tree, dict):
        out = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    return next(leaves)


def _stack(leaves):
    """One leaf a micro-batch -> one array with a leading [gas] axis:
    torch.stack where a leaf is a tensor (on its device), else through
    numpy."""
    if any(isinstance(leaf, torch.Tensor) for leaf in leaves):
        return torch.stack([torch.as_tensor(leaf) for leaf in leaves])
    return np.stack([np.asarray(leaf) for leaf in leaves])


def stack_microbatches(batches):
    """Stack ``gas`` collated micro-batches into one batch of the same
    structure whose leaves carry a leading ``[gas, ...]`` axis: the input
    of the fused whole-step path (runtime/fused_step.py).  Tuples, lists
    and dicts of numpy arrays or torch tensors, as the JAX function takes
    pytrees; every micro-batch must share one structure and per-leaf
    shape (the loader contract already guarantees this under drop_last).
    """
    if not batches:
        raise ValueError("stack_microbatches needs at least one microbatch")
    first = _treedef(batches[0])
    for i, b in enumerate(batches[1:], start=1):
        if _treedef(b) != first:
            raise ValueError(
                f"microbatch {i} has tree structure PyTreeDef({_treedef(b)}) "
                f"!= microbatch 0's PyTreeDef({first}) — all gas "
                "microbatches must collate identically")
    per_leaf = zip(*[_leaves(b) for b in batches])
    return _rebuild(batches[0], iter([_stack(list(ls)) for ls in per_leaf]))


class RepeatingLoader:
    """Wraps an iterator to restart on StopIteration
    (reference: dataloader.py RepeatingLoader)."""

    def __init__(self, loader: Iterable):
        self.loader = loader
        self.data_iter = iter(loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self.data_iter)
        except StopIteration:
            if hasattr(self.loader, "set_epoch"):
                self.loader.set_epoch(getattr(self.loader, "epoch", 0) + 1)
            self.data_iter = iter(self.loader)
            return next(self.data_iter)
