"""Data parallelism on torch.distributed (port of ws3d_tpu/parallel/mesh.py).

JAX drives a 1-D `data` mesh of devices from one process; PyTorch's idiom is
one process a device. A `Group` is this process's place in such a run: its
rank, the world size, its device and the backend (NCCL between CUDA
devices, gloo on the CPU or where the caller names it). The JAX semantics
are kept function by function:

- `shard_batch` gives each rank its contiguous slice of a global host batch,
  in the order of P('data'); a leaf whose leading dimension the world size
  does not divide is replicated;
- `shard_batch_multihost` takes each process's own slice of the global
  batch instead (jax.make_array_from_process_local_data);
- `replicate` broadcasts a module's parameters and buffers from rank 0
  (device_put(state, replicated));
- `data_parallel_step` runs a train step built with group= (the steps'
  axis_name) on the rank's shard: each rank differentiates its shard with
  its own train-mode BatchNorm statistics, as shard_map does (this is not
  SyncBatchNorm), and the step replaces gradients, BN running statistics
  and aux values by their mean over the ranks before the optimizer applies
  the gradients;
- `data_parallel_jit` runs a train step built without a group on the
  rank's shard as one step on the global batch, as XLA's propagation path
  compiles it: inside parallel.global_batch's context BatchNorm, the loss
  normalisers and the aux sums reduce over every rank's rows (a
  differentiable all-reduce) and dropout draws the global batch's mask, so
  the loss, the aux values and the new BN statistics are the
  single-process step's on the whole batch, and its gradients within
  float rounding;
- `data_parallel_infer` runs an inference function on the rank's scenes and
  all-gathers its outputs in scene order.

JAX's `donate_state` has no counterpart: the port updates parameters and
optimizer state in place.

Every group has a timeout, so a collective that hangs fails instead.
"""
from __future__ import annotations

import datetime
import io
import math
import os
import queue as queue_mod
import socket
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT_S = 600.0


@dataclass(frozen=True)
class Group:
    """This process's rank in a data-parallel run of `world_size` ranks."""
    rank: int
    world_size: int
    device: torch.device
    backend: str

    @property
    def is_main(self) -> bool:
        """Rank 0 alone logs and writes outputs."""
        return self.rank == 0

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()


class LocalShard(dict):
    """A rank's slice of a global batch, already on the rank's device
    (shard_batch_multihost); `global_size` is the global batch size."""

    def __init__(self, tensors: Dict[str, torch.Tensor], global_size: int):
        super().__init__(tensors)
        self.global_size = int(global_size)


def _check_nccl(local_ranks: int) -> None:
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if local_ranks > visible:
        raise RuntimeError(
            f"NCCL needs a CUDA device of its own for each rank: "
            f"{local_ranks} ranks on this host, {visible} CUDA devices "
            f"visible")


def _rank_device(device, local_rank: int) -> torch.device:
    """None or "cuda": the rank's own card; "cuda:k" or "cpu": as given."""
    if device is None:
        return torch.device("cuda", local_rank)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", local_rank)
    return device


def init_group(rank: Optional[int] = None,
               world_size: Optional[int] = None, *,
               backend: Optional[str] = None, device=None,
               init_method: Optional[str] = None,
               timeout: float = TIMEOUT_S) -> Group:
    """Join a process group and return this process's Group.

    Under torchrun (RANK and WORLD_SIZE set, `rank` not given) the rank,
    world size, LOCAL_RANK and the rendezvous come from the environment;
    otherwise `rank`, `world_size` and `init_method` (tcp://host:port) are
    required. `device`: None or "cuda" gives rank r the CUDA device
    LOCAL_RANK; "cpu" or "cuda:k" puts the rank there. The backend is NCCL
    for a CUDA device and gloo for the CPU unless `backend` is given. NCCL
    with more ranks on this host than CUDA devices visible raises; there is
    no switch to gloo."""
    if rank is None and "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        local_ranks = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
        init_method = init_method or "env://"
    else:
        if rank is None or world_size is None or init_method is None:
            raise ValueError("init_group needs rank, world_size and "
                             "init_method outside torchrun")
        local_rank, local_ranks = rank, world_size
    dev = _rank_device(device, local_rank)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        _check_nccl(local_ranks)
        if dev != torch.device("cuda", local_rank):
            raise ValueError(f"NCCL puts local rank {local_rank} on "
                             f"cuda:{local_rank}, not {dev}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout))
    return Group(rank, world_size, dev, backend)


def make_mesh(n_devices: Optional[int] = None, device=None) -> Group:
    """The Group of this process in a torchrun run, which must have
    `n_devices` ranks when that is given (make_mesh(n) of the JAX
    package)."""
    if "WORLD_SIZE" not in os.environ:
        raise RuntimeError("make_mesh joins a torchrun run (RANK and "
                           "WORLD_SIZE unset); use launch() to start ranks")
    world = int(os.environ["WORLD_SIZE"])
    if n_devices is not None and n_devices != world:
        raise ValueError(f"--mesh {n_devices} under torchrun with "
                         f"WORLD_SIZE {world}")
    return init_group(device=device)


def destroy_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world_size, backend, device, init_method, timeout,
               threads, results, args_path) -> None:
    try:
        torch.set_num_threads(threads)
        args = torch.load(args_path, weights_only=False)
        group = init_group(rank, world_size, backend=backend, device=device,
                           init_method=init_method, timeout=timeout)
        out = fn(group, *args)
        destroy_group()
        buf = io.BytesIO()
        torch.save(out, buf)
        results.put((rank, True, buf.getvalue()))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def launch(fn: Callable, world_size: int, *args, backend: Optional[str] = None,
           device=None, timeout: Optional[float] = TIMEOUT_S) -> List[Any]:
    """Run fn(group, *args) in `world_size` new processes (start method
    spawn), one a rank, joined over tcp://localhost on a free port; return
    each rank's result, in rank order (results go through torch.save, so
    tensors come back on their devices).

    `device` and `backend` as init_group's (default: one CUDA device a
    rank, NCCL). On CUDA the kernels are built here, once, before any rank
    starts. The ranks share the host's CPU threads. A rank that raises or
    dies makes launch stop the others and raise RuntimeError with its
    traceback; ranks that have not all returned after `timeout` seconds are
    stopped and TimeoutError is raised. `timeout` None sets no deadline for
    the run (a tool's whole training or eval): a hung collective still
    fails after the group's TIMEOUT_S. `fn` and `args` must pickle (fn a
    module-level function); the arguments reach the ranks through a file
    in a temporary directory, so starting a rank never waits on a pipe."""
    if world_size < 1:
        raise ValueError(f"world_size {world_size}")
    if (backend or ("nccl" if _rank_device(device, 0).type == "cuda"
                    else "gloo")) == "nccl":
        _check_nccl(world_size)           # before any process starts
    if _rank_device(device, 0).type == "cuda":
        from ws3d_tpu_torch.ops import _kernels
        _kernels.build()                  # once, not once a rank
    group_timeout = TIMEOUT_S if timeout is None else timeout
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    init_method = f"tcp://localhost:{free_port()}"
    threads = max(1, torch.get_num_threads() // world_size)
    got: Dict[int, Any] = {}
    with tempfile.TemporaryDirectory(prefix="ws3d_launch_") as tmp:
        args_path = os.path.join(tmp, "args.pt")
        torch.save(args, args_path)
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world_size, backend, device,
                                   init_method, group_timeout, threads,
                                   results,
                                   args_path))
                 for r in range(world_size)]
        deadline = (math.inf if timeout is None
                    else time.monotonic() + timeout)
        try:
            for p in procs:
                p.start()
            while len(got) < world_size:
                try:
                    rank, ok, payload = results.get(timeout=1.0)
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(
                            f"rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} and no result")
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"{world_size - len(got)} of {world_size} ranks "
                            f"still running after {timeout:.0f} s")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{payload}")
                got[rank] = torch.load(io.BytesIO(payload),
                                       weights_only=False)
            for p in procs:
                p.join(timeout=min(max(deadline - time.monotonic(), 5.0),
                                   TIMEOUT_S))
        finally:
            for p in procs:
                if p.pid is not None and p.is_alive():
                    p.terminate()
                    p.join(5.0)
                if p.pid is not None and p.is_alive():
                    p.kill()
                    p.join()
    return [got[r] for r in range(world_size)]


def _to_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


def shard_batch(batch: Dict[str, Any], group: Group) -> Dict[str, torch.Tensor]:
    """The rank's contiguous slice [r*B/W, (r+1)*B/W) of every leaf of a
    global batch (NumPy arrays or tensors), on the rank's device; a 0-d
    leaf, or one whose leading dimension W does not divide, is
    replicated."""
    W, r = group.world_size, group.rank

    def put(x) -> torch.Tensor:
        if np.ndim(x) >= 1 and np.shape(x)[0] % W == 0:
            n = np.shape(x)[0] // W
            x = x[r * n:(r + 1) * n]
        return _to_tensor(x).contiguous().to(group.device)

    return {k: put(v) for k, v in batch.items()}


def shard_batch_multihost(local: Dict[str, Any], group: Group) -> LocalShard:
    """The multi-host hook: each process passes only its own slice of the
    global batch (every leaf batch-leading). Checks that every rank's slice
    has the same leading size for every leaf, as P('data') needs, and
    returns the slice on the rank's device with the global batch size, the
    sum of the slices."""
    sizes = [int(np.shape(v)[0]) if np.ndim(v) else -1
             for v in local.values()]
    if any(s < 0 for s in sizes):
        raise ValueError("shard_batch_multihost: every leaf must have a "
                         "leading batch dimension")
    table = torch.zeros((group.world_size, len(sizes)), dtype=torch.int64,
                        device=group.device)
    table[group.rank] = torch.tensor(sizes, dtype=torch.int64)
    dist.all_reduce(table)
    table = table.cpu()
    if bool((table != table[group.rank]).any()):
        raise ValueError(f"shard_batch_multihost: the ranks' slices differ "
                         f"in size: {table.tolist()} (rank x leaf)")
    return LocalShard({k: _to_tensor(v).contiguous().to(group.device)
                       for k, v in local.items()},
                      global_size=int(table[:, 0].sum()))


def _bucketed(tensors: List[torch.Tensor], op: Callable) -> None:
    """op(flat) on one flat buffer a dtype holding every tensor, then the
    result copied back in place (bool travels as uint8)."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for dtype, ts in by_dtype.items():
            wire = torch.uint8 if dtype == torch.bool else dtype
            flat = torch.cat([t.detach().reshape(-1).to(wire) for t in ts])
            op(flat)
            offset = 0
            for t in ts:
                n = t.numel()
                t.copy_(flat[offset:offset + n].view(t.shape).to(dtype))
                offset += n


def replicate(module: torch.nn.Module, group: Group) -> None:
    """Broadcast every parameter and buffer of `module` from rank 0."""
    _bucketed([*module.parameters(), *module.buffers()],
              lambda flat: dist.broadcast(flat, src=0))


def all_reduce_mean(tensors: List[torch.Tensor], group: Group) -> None:
    """Replace each floating tensor by its mean over the ranks, in place:
    one collective a dtype, every rank gets the same bits."""
    bad = [t.dtype for t in tensors if not t.is_floating_point()]
    if bad:
        raise TypeError(f"all_reduce_mean takes floating tensors, not {bad}")

    def op(flat):
        dist.all_reduce(flat)
        flat.div_(group.world_size)

    _bucketed(tensors, op)


def rank_seed(seed: int, group: Optional[Group]) -> int:
    """The dropout generator's seed of a rank: `seed` on rank 0 (and without
    a group), a stream of its own on every other rank (fold_in(rng,
    axis_index) of the JAX steps)."""
    return int(seed) + (group.rank << 32 if group is not None else 0)


def _rank_shard(batch, group: Group):
    """The rank's shard of a global batch (shard_batch), or a LocalShard as
    it is; a leaf whose leading dimension the world size does not divide
    raises, as shard_map does."""
    if isinstance(batch, LocalShard):
        return batch
    for k, v in batch.items():
        if np.ndim(v) == 0 or np.shape(v)[0] % group.world_size:
            raise ValueError(
                f"batch leaf {k} of shape {tuple(np.shape(v))} does "
                f"not split over {group.world_size} ranks")
    return shard_batch(batch, group)


def data_parallel_step(step: Callable, group: Group) -> Callable:
    """wrapper(batch, generator, bn_momentum) for a step built with
    group=group (training.trainer.make_*_train_step): shards a global batch
    with shard_batch and runs the step on the rank's slice; a LocalShard
    (shard_batch_multihost) runs as it is. A leaf whose leading dimension
    the world size does not divide raises, as shard_map does."""
    def wrapper(batch, generator, bn_momentum: float = 0.1):
        return step(_rank_shard(batch, group), generator, bn_momentum)

    return wrapper


def data_parallel_jit(step: Callable, group: Group) -> Callable:
    """wrapper(batch, generator, bn_momentum) for a step built WITHOUT a
    group (training.trainer.make_*_train_step(..., group=None)): one step on
    the global batch, each rank computing its shard (shard_batch, or a
    LocalShard as it is).

    The step runs inside parallel.global_batch.global_batch(group): every
    reduction over the batch axis (BatchNorm's mean and two-pass variance,
    the losses' masked means, counts and `any` gates, the aux sums) is a
    differentiable all-reduce over the ranks, and train-mode dropout draws
    the mask of the whole batch and keeps the rank's rows. Every rank then
    holds the same global loss and aux values and writes the same BN
    running statistics. The backward of each all-reduce sums the cotangent
    of W identical losses, so each rank's parameter gradient is W times its
    shard's share of the global gradient; the step's gradient reduction is
    therefore a mean over the ranks (training.trainer._gradients), and
    every rank applies dL/dtheta of the global loss.

    The model must be the same on every rank (replicate) and the dropout
    generator in the same state on every rank (JAX passes one replicated
    rng); the world size must divide the batch evenly."""
    def wrapper(batch, generator, bn_momentum: float = 0.1):
        from ws3d_tpu_torch.parallel.global_batch import global_batch
        shard = _rank_shard(batch, group)
        with global_batch(group):
            return step(shard, generator, bn_momentum)

    return wrapper


def all_gather(t: torch.Tensor, group: Group) -> torch.Tensor:
    """The ranks' `t` concatenated along dim 0 in rank order (a 0-d `t`
    gives one value a rank)."""
    x = (t if t.dim() else t[None]).contiguous()
    wire = x.to(torch.uint8) if x.dtype == torch.bool else x
    parts = [torch.empty_like(wire) for _ in range(group.world_size)]
    dist.all_gather(parts, wire)
    return torch.cat(parts).to(x.dtype)


def data_parallel_infer(fn: Callable, group: Group) -> Callable:
    """infer(batch) for fn(batch) -> tensor or dict of tensors: runs fn on
    the rank's contiguous slice of the global scene batch (B divisible by
    the world size) and all-gathers every output in scene order. `fn` is
    built for the group (pipeline.make_two_stage_fn(..., group=group)), so
    what it pools over the batch it pools over the whole batch: its 0-d
    outputs (n_live, spilled) are already the whole batch's and come back
    as they are. Every rank gets the whole result."""
    def infer(batch):
        if np.shape(batch)[0] % group.world_size:
            raise ValueError(f"a batch of {np.shape(batch)[0]} scenes does "
                             f"not split over {group.world_size} ranks")
        out = fn(shard_batch({"x": batch}, group)["x"])
        if isinstance(out, torch.Tensor):
            return all_gather(out, group)
        return {k: v if v.dim() == 0 else all_gather(v, group)
                for k, v in out.items()}

    return infer
