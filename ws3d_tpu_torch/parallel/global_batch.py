"""The global-batch context of parallel.data_parallel_jit.

JAX's data_parallel_jit compiles a step on the whole sharded batch, so
every reduction over the batch axis (BatchNorm's statistics, the losses'
normalisers and sums, the aux sums) covers the global batch, and dropout
draws one mask for it. The port runs one process a rank on its shard; while
`global_batch(group)` is entered, the functions here make those reductions
global with a differentiable all-reduce (torch.distributed.nn.functional.
all_reduce, whose backward all-reduces the cotangent). Outside it they are
the local reductions, bit for bit.

The gradient scaling: inside the context every rank computes the same
global loss L, whose every path from a rank's data runs through one of
these sums. A rank's backward seeds dL = 1; each all-reduce's backward sums
the cotangent over the W ranks, so it hands W * dL/dS to the rank's side of
every sum S, and the rank's parameter gradient is W times its shard's share
of dL/dtheta. The sum over the ranks of those is W * dL/dtheta: the
parameter gradients are therefore all-reduced as a MEAN
(training.trainer._gradients), which gives every rank dL/dtheta.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

_GROUP = None


@contextlib.contextmanager
def global_batch(group):
    """Reduce over the whole batch of `group` (a parallel.Group) inside."""
    global _GROUP
    if _GROUP is not None:
        raise RuntimeError("global_batch contexts do not nest")
    _GROUP = group
    try:
        yield group
    finally:
        _GROUP = None


def active() -> Optional[object]:
    """The Group of the global-batch step in progress, or None."""
    return _GROUP


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the ranks (differentiable), or x outside a global
    batch. Every rank must call it, in the same order."""
    if _GROUP is None:
        return x
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(x.contiguous())


def batch_any(mask: torch.Tensor) -> torch.Tensor:
    """torch.any(mask) over the whole batch."""
    if _GROUP is None:
        return torch.any(mask)
    return batch_sum(torch.sum(mask.to(torch.int32))) > 0


def mean_var(x: torch.Tensor):
    """(mean, biased variance) over every axis but the last: torch.mean and
    torch.var locally (and in a global batch of one rank, which is the
    local batch); over the whole batch of W > 1 ranks one sum for the
    mean, then one sum of squared deviations from it (two passes, as
    jnp.var), each over the global count."""
    axes = tuple(range(x.dim() - 1))
    if _GROUP is None or _GROUP.world_size == 1:
        return torch.mean(x, dim=axes), torch.var(x, dim=axes, correction=0)
    count = x.numel() // x.shape[-1] * _GROUP.world_size
    mean = batch_sum(torch.sum(x, dim=axes)) / count
    d = x - mean
    return mean, batch_sum(torch.sum(d * d, dim=axes)) / count


def rows(shape, draw):
    """draw(shape) for a batch-leading shape: locally as it is; in a global
    batch the rank's rows of draw((W * B,) + shape[1:]), so that a seeded
    generator in the same state on every rank draws the single-process
    step's values."""
    if _GROUP is None:
        return draw(shape)
    b = shape[0]
    full = draw((_GROUP.world_size * b,) + tuple(shape[1:]))
    return full[_GROUP.rank * b:(_GROUP.rank + 1) * b]
