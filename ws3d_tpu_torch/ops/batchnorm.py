"""Train-mode BatchNorm followed by ReLU as one autograd Function,
bn_relu_train, on the hand-written kernels of csrc/batchnorm.cu.

The caller takes the batch statistics (torch.mean and torch.var, without
autograd) and inv = 1 / sqrt(var + eps); the Function computes

    y = relu(((x - mean) * inv) * scale + bias)

over the trailing channel axis, the composition's operations in its order,
so y equals the composition's output bit for bit. Its backward gives dx,
dscale and dbias by the analytic formula, which also carries the gradient
through the mean and the variance: with gm = g [y > 0] and
xhat = (x - mean) inv over N rows,

    dbias = sum gm,  dscale = sum gm xhat,
    dx = scale inv (gm - dbias / N - xhat dscale / N).

It saves x, mean, inv, scale and bias, and nothing of size x else. The
forward is one launch (LAUNCHES["bn_relu"]), the backward two: the
per-channel sums (dbias, dscale; LAUNCHES["bn_relu_sums"]), added in a
fixed order so that two runs give the same bits, then dx
(LAUNCHES["bn_relu_dx"]). In a global batch of W > 1 ranks
(parallel.global_batch) the caller's statistics are the global ones, and
the backward all-reduces the sums between its two kernels and takes the
global N in dx, while dscale and dbias stay the rank's own sums, as the
composition's parameter gradients are (the trainer averages them over the
ranks). The Function takes CUDA tensors only; on the CPU the model keeps
the composition, and the *_plain functions below are the kernels'
references.
"""
from __future__ import annotations

import functools

import torch

from ws3d_tpu_torch.ops import _kernels
from ws3d_tpu_torch.parallel import global_batch
from ws3d_tpu_torch.utils.profiling import count

# the kernels' widths: a thread holds 4 channels, and a block of 256
# threads at least one row
_THREADS = 256
_MAX_WIDTH = 4 * _THREADS
# partial sums' blocks a multiprocessor (the workspace's size)
_SUM_BLOCKS_PER_SM = 2


def bn_relu_plain(x, mean, inv, scale, bias):
    """The composition: relu(((x - mean) * inv) * scale + bias)."""
    return torch.relu((x - mean) * inv * scale + bias)


def _masked(g, x, mean, inv, scale, bias):
    xhat = (x - mean) * inv
    return torch.where(xhat * scale + bias > 0, g, torch.zeros_like(g)), xhat


def bn_relu_sums_plain(g, x, mean, inv, scale, bias) -> torch.Tensor:
    """The backward's sums over x's rows: (2, C), dbias then dscale."""
    gm, xhat = _masked(g, x, mean, inv, scale, bias)
    axes = tuple(range(x.dim() - 1))
    return torch.stack([torch.sum(gm, dim=axes),
                        torch.sum(gm * xhat, dim=axes)])


def bn_relu_dx_plain(g, x, mean, inv, scale, bias, sums, n) -> torch.Tensor:
    """dx from the sums (2, C) over n rows."""
    gm, xhat = _masked(g, x, mean, inv, scale, bias)
    return scale * inv * (gm - sums[0] / n - xhat * (sums[1] / n))


def bn_relu_backward_plain(g, x, mean, inv, scale, bias):
    """The analytic backward on one process: (dx, dscale, dbias)."""
    sums = bn_relu_sums_plain(g, x, mean, inv, scale, bias)
    dx = bn_relu_dx_plain(g, x, mean, inv, scale, bias, sums,
                          x.numel() // x.shape[-1])
    return dx, sums[1], sums[0]


@functools.lru_cache(maxsize=None)
def _sum_blocks(device_index: int) -> int:
    props = torch.cuda.get_device_properties(device_index)
    return _SUM_BLOCKS_PER_SM * props.multi_processor_count


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous, its data 16-byte aligned (a fresh copy otherwise)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(x: torch.Tensor, *vecs: torch.Tensor) -> None:
    c = x.shape[-1] if x.dim() else 0
    if x.dim() < 2 or c % 4 or not 0 < c <= _MAX_WIDTH:
        raise ValueError(f"bn_relu takes (..., C) with C a multiple of 4 up "
                         f"to {_MAX_WIDTH}, not {tuple(x.shape)}")
    _kernels.check_cuda(x, "bn_relu x", torch.float32, tuple(x.shape))
    for name, v in zip(("mean", "inv", "scale", "bias"), vecs):
        _kernels.check_cuda(v, f"bn_relu {name}", torch.float32, (c,))


def bn_relu_forward_cuda(x, mean, inv, scale, bias) -> torch.Tensor:
    """The forward kernel: x (..., C) f32 CUDA -> y (..., C)."""
    x = _aligned(x)
    _check(x, mean, inv, scale, bias)
    y = torch.empty_like(x)
    c = x.shape[-1]
    _kernels.launch(
        "bn_relu", "ws3d_bn_relu_forward", x.data_ptr(), mean.data_ptr(),
        inv.data_ptr(), scale.data_ptr(), bias.data_ptr(), x.numel() // c, c,
        y.data_ptr(), _kernels.stream_ptr(x))
    return y


def bn_relu_sums_cuda(g, x, mean, inv, scale, bias) -> torch.Tensor:
    """Kernel 1 of the backward: the sums (2, C) over x's rows, dbias then
    dscale, added in a fixed order."""
    x, g = _aligned(x), _aligned(g)
    _check(x, mean, inv, scale, bias)
    _kernels.check_cuda(g, "bn_relu g", torch.float32, tuple(x.shape))
    c = x.shape[-1]
    blocks = _sum_blocks(x.device.index)
    # the blocks' partial sums, then one int32 ticket
    workspace = torch.empty(blocks * 2 * c + 1, dtype=torch.float32,
                            device=x.device)
    sums = torch.empty((2, c), dtype=torch.float32, device=x.device)
    _kernels.launch(
        "bn_relu_sums", "ws3d_bn_relu_sums", x.data_ptr(), g.data_ptr(),
        mean.data_ptr(), inv.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        x.numel() // c, c, blocks, workspace.data_ptr(), sums.data_ptr(),
        _kernels.stream_ptr(x))
    return sums


def bn_relu_dx_cuda(g, x, mean, inv, scale, bias, sums, n) -> torch.Tensor:
    """Kernel 2 of the backward: dx of x's rows from the sums (2, C) over
    n rows (x's own, or a global batch's)."""
    x, g = _aligned(x), _aligned(g)
    _check(x, mean, inv, scale, bias)
    c = x.shape[-1]
    _kernels.check_cuda(g, "bn_relu g", torch.float32, tuple(x.shape))
    _kernels.check_cuda(sums, "bn_relu sums", torch.float32, (2, c))
    dx = torch.empty_like(x)
    _kernels.launch(
        "bn_relu_dx", "ws3d_bn_relu_dx", x.data_ptr(), g.data_ptr(),
        mean.data_ptr(), inv.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        sums.data_ptr(), x.numel() // c, c, int(n), dx.data_ptr(),
        _kernels.stream_ptr(x))
    return dx


def bn_relu_backward_cuda(g, x, mean, inv, scale, bias, world: int = 1):
    """The backward's two kernels: (dx, dscale, dbias). With world > 1, in
    a global batch of that many ranks with x the rank's rows, the sums are
    all-reduced over the ranks before dx, which then takes the global row
    count; dscale and dbias are the rank's own sums."""
    sums = bn_relu_sums_cuda(g, x, mean, inv, scale, bias)
    total = sums
    if world > 1:
        # every rank runs the backward's layers in the same order
        total = sums.clone()
        torch.distributed.all_reduce(total)
    dx = bn_relu_dx_cuda(g, x, mean, inv, scale, bias, total,
                         x.numel() // x.shape[-1] * world)
    return dx, sums[1], sums[0]


class _BNReLU(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, mean, inv, scale, bias):
        ctx.save_for_backward(x, mean, inv, scale, bias)
        group = global_batch.active()
        ctx.world = 1 if group is None else group.world_size
        return bn_relu_forward_cuda(x, mean, inv, scale, bias)

    @staticmethod
    def backward(ctx, g):
        x, mean, inv, scale, bias = ctx.saved_tensors
        dx, dscale, dbias = bn_relu_backward_cuda(g, x, mean, inv, scale,
                                                  bias, ctx.world)
        return dx, None, None, dscale, dbias


def bn_relu_train(x: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor,
                  scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """relu(((x - mean) * inv) * scale + bias) over the trailing axis of a
    CUDA x, differentiable in x, scale and bias (mean and inv are the batch
    statistics of x, a global batch's in a global batch, taken without
    autograd: the backward's formula covers them). Raises where the
    kernels do not take x (not f32, or C not a multiple of 4 up to 1,024).
    Counts `bn_relu.fused` once a call."""
    count("bn_relu.fused")
    return _BNReLU.apply(x, mean, inv, scale, bias)
