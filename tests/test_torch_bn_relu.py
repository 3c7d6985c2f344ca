"""Train-mode BatchNorm + ReLU (ops/batchnorm.py, csrc/batchnorm.cu)
against the composition it replaces.

The CPU tests hold the CPU path of SharedMLP and HeadMLP, which keeps the
composition, bit for bit to that composition written out here, the
analytic backward (on one process and summed over the ranks of a global
batch) to autograd in f64, and the kernels' plain references to autograd.
The tests marked `cuda` skip without a card; on the card run them with

    python -m pytest tests/test_torch_bn_relu.py -q -m cuda --noconftest

This file imports no JAX.
"""
import copy

import numpy as np
import pytest
import torch

from ws3d_tpu_torch.models.layers import (BN_EPS, HeadMLP, SharedMLP,
                                          dropout)
from ws3d_tpu_torch.ops import _kernels, batchnorm
from ws3d_tpu_torch.utils.profiling import TRACE, count

BN_LAUNCHES = ("bn_relu", "bn_relu_sums", "bn_relu_dx")

# every BatchNorm width of stage 1 (SA, FP and the heads)
STAGE1_WIDTHS = (16, 32, 64, 96, 128, 196, 256, 384, 512)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bn_composition(bn, x, train, momentum):
    """layers.BatchNorm.forward as the composition: the statistics with
    autograd, the running ones updated, then the four elementwise ops."""
    if train:
        axes = tuple(range(x.dim() - 1))
        mean = torch.mean(x, dim=axes)
        var = torch.var(x, dim=axes, correction=0)
        with torch.no_grad():
            m = float(momentum)
            bn.mean.copy_((1 - m) * bn.mean + m * mean)
            bn.var.copy_((1 - m) * bn.var + m * var)
    else:
        mean, var = bn.mean, bn.var
    inv = torch.reciprocal(torch.sqrt(var + BN_EPS))
    return (x - mean) * inv * bn.scale + bn.bias


def _shared_mlp_composition(mlp, x, train, momentum):
    for k in range(len(mlp.channels)):
        x = getattr(mlp, f"Dense_{k}")(x)
        if mlp.use_bn:
            x = _bn_composition(getattr(mlp, f"BatchNorm_{k}"), x.float(),
                                train, momentum)
        x = torch.relu(x)
    return x.float() if mlp.out_f32 else x


def _head_mlp_composition(head, x, train, momentum, generator):
    for i in range(head.n_hidden):
        x = getattr(head, f"Dense_{i}")(x)
        if head.use_bn:
            x = _bn_composition(getattr(head, f"BatchNorm_{i}"), x.float(),
                                train, momentum)
        x = torch.relu(x)
        if i == 0 and train and head.dp_ratio > 0:
            x = dropout(x, head.dp_ratio, generator)
    return getattr(head, f"Dense_{head.n_hidden}")(x.float())


def _randomise(module, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("scale"):
                p.copy_(0.5 + torch.rand(p.shape, generator=g))
            else:
                p.copy_(torch.randn(p.shape, generator=g) * 0.3)
    return module


def _grads(module, out, seed):
    w = torch.randn(out.shape, generator=torch.Generator().manual_seed(seed),
                    dtype=out.dtype).to(out.device)
    params = [p for _, p in sorted(module.named_parameters())]
    return torch.autograd.grad(torch.sum(out * w), params)


def _states_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    return sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k])
                                          for k in sa)


# ----------------------------------------------------------------- CPU


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_shared_mlp_cpu_train_is_the_composition(dtype):
    mlp = _randomise(SharedMLP(7, [16, 32, 64], dtype=dtype), 1)
    ref = copy.deepcopy(mlp)
    x = torch.randn(2, 33, 5, 7, generator=torch.Generator().manual_seed(2))
    before = dict(_kernels.LAUNCHES)
    out = mlp(x, train=True, bn_momentum=0.05)
    want = _shared_mlp_composition(ref, x, True, 0.05)
    assert torch.equal(out, want)
    assert _states_equal(mlp, ref)
    for a, b in zip(_grads(mlp, out, 3), _grads(ref, want, 3)):
        assert torch.equal(a, b)
    assert _kernels.LAUNCHES == before


def test_shared_mlp_cpu_eval_is_the_composition():
    mlp = _randomise(SharedMLP(5, [32, 96]), 4)
    ref = copy.deepcopy(mlp)
    mlp(torch.randn(4, 20, 5), train=True)          # running statistics
    _shared_mlp_composition(ref, torch.randn(4, 20, 5), True, 0.1)
    x = torch.randn(3, 11, 5)
    assert torch.equal(mlp(x), _shared_mlp_composition(mlp, x, False, 0.1))


@pytest.mark.parametrize("dp_ratio", [0.0, 0.5])
def test_head_mlp_cpu_train_is_the_composition(dp_ratio):
    head = _randomise(HeadMLP(128, [128, 64], 40, dp_ratio=dp_ratio), 5)
    ref = copy.deepcopy(head)
    x = torch.randn(3, 50, 128, generator=torch.Generator().manual_seed(6))
    out = head(x, train=True, bn_momentum=0.1,
               generator=torch.Generator().manual_seed(7))
    want = _head_mlp_composition(ref, x, True, 0.1,
                                 torch.Generator().manual_seed(7))
    assert torch.equal(out, want)
    assert _states_equal(head, ref)
    for a, b in zip(_grads(head, out, 8), _grads(ref, want, 8)):
        assert torch.equal(a, b)


def _case(shape, seed, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    c = shape[-1]
    x = torch.randn(shape, generator=g, dtype=dtype) * 2 + 0.3
    scale = (0.5 + torch.rand(c, generator=g, dtype=dtype))
    bias = torch.randn(c, generator=g, dtype=dtype) * 0.5
    cot = torch.randn(shape, generator=g, dtype=dtype)
    return x, scale, bias, cot


@pytest.mark.parametrize("shape", [(300, 16), (4, 37, 3, 24), (2, 9, 196)])
def test_bn_relu_formula_matches_autograd_f64(shape):
    """The backward's formula, written out here, against autograd of the
    composition (statistics and all) in f64."""
    x, scale, bias, cot = _case(shape, 11)
    x.requires_grad_(True)
    scale.requires_grad_(True)
    bias.requires_grad_(True)
    axes = tuple(range(x.dim() - 1))
    mean = torch.mean(x, dim=axes)
    var = torch.var(x, dim=axes, correction=0)
    inv = torch.reciprocal(torch.sqrt(var + BN_EPS))
    y = torch.relu((x - mean) * inv * scale + bias)
    ref = torch.autograd.grad(y, (x, scale, bias), cot)
    with torch.no_grad():
        n = x.numel() // x.shape[-1]
        xhat = (x - mean) * inv
        gm = cot * (xhat * scale + bias > 0)
        dbias = gm.sum(axes)
        dscale = (gm * xhat).sum(axes)
        dx = scale * inv * (gm - dbias / n - xhat * dscale / n)
    for got, want in zip((dx, dscale, dbias), ref):
        torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("world", [2, 3])
def test_bn_relu_formula_over_ranks_f64(world):
    """The backward as a global batch of `world` ranks runs it: each
    rank's sums, added over the ranks, then each rank's dx over the global
    N; each rank's dscale and dbias its own sums, which add up to the
    whole batch's. Against autograd of the composition on the whole batch
    in f64."""
    x, scale, bias, cot = _case((6, 35, 64), 13)
    x.requires_grad_(True)
    scale.requires_grad_(True)
    bias.requires_grad_(True)
    axes = (0, 1)
    mean = torch.mean(x, dim=axes)
    inv = torch.reciprocal(torch.sqrt(torch.var(x, dim=axes, correction=0)
                                      + BN_EPS))
    y = torch.relu((x - mean) * inv * scale + bias)
    want = torch.autograd.grad(y, (x, scale, bias), cot)
    with torch.no_grad():
        n = x.numel() // x.shape[-1]
        shards = [(xr, gr) for xr, gr in zip(torch.chunk(x, world),
                                             torch.chunk(cot, world))]
        sums = []
        for xr, gr in shards:
            xhat = (xr - mean) * inv
            gm = gr * (xhat * scale + bias > 0)
            sums.append(torch.stack([gm.sum(axes), (gm * xhat).sum(axes)]))
        total = sum(sums)
        dx = torch.cat([
            scale * inv * (gr * ((xr - mean) * inv * scale + bias > 0)
                           - total[0] / n
                           - (xr - mean) * inv * total[1] / n)
            for xr, gr in shards])
        dscale = sum(s_[1] for s_ in sums)
        dbias = sum(s_[0] for s_ in sums)
    for got, ref in zip((dx, dscale, dbias), want):
        torch.testing.assert_close(got, ref, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 2e-5)])
def test_bn_relu_plain_references(dtype, tol):
    """The kernels' references: bn_relu_plain is the composition's bits;
    bn_relu_backward_plain is autograd's within the dtype's rounding."""
    x, scale, bias, cot = _case((5, 41, 32), 12, dtype)
    leaves = [t.clone().requires_grad_(True) for t in (x, scale, bias)]
    xr, sr, br = leaves
    mean = torch.mean(xr, dim=(0, 1))
    inv = torch.reciprocal(torch.sqrt(
        torch.var(xr, dim=(0, 1), correction=0) + BN_EPS))
    yr = torch.relu((xr - mean) * inv * sr + br)
    want = torch.autograd.grad(yr, leaves, cot)
    mean, inv = mean.detach(), inv.detach()
    assert torch.equal(batchnorm.bn_relu_plain(x, mean, inv, scale, bias),
                       yr.detach())
    got = batchnorm.bn_relu_backward_plain(cot, x, mean, inv, scale, bias)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=tol,
                                   atol=tol * float(b.abs().max()))


def test_cpu_train_counts_nothing():
    mlp = SharedMLP(4, [16, 32])
    before = dict(_kernels.LAUNCHES)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity
                                            .CPU]):
        mlp(torch.randn(2, 10, 4), train=True)
        counters = dict(TRACE.totals()["counters"])
    assert "bn_relu.fused" not in counters
    assert _kernels.LAUNCHES == before


# ----------------------------------------------------------------- card


def _card_case(dev, rows_shape, c, seed, offset=0):
    rng = np.random.RandomState(seed)
    n = int(np.prod(rows_shape)) * c
    flat = torch.from_numpy(
        (rng.randn(n + offset) * 2 + 0.3).astype(np.float32)).to(dev)
    x = flat[offset:].view(*rows_shape, c)
    scale = torch.from_numpy((0.5 + rng.rand(c)).astype(np.float32)).to(dev)
    bias = torch.from_numpy((rng.randn(c) * 0.5).astype(np.float32)).to(dev)
    cot = torch.from_numpy(rng.randn(*rows_shape, c).astype(np.float32)).to(
        dev)
    return x, scale, bias, cot


def _stats(x):
    axes = tuple(range(x.dim() - 1))
    with torch.no_grad():
        mean = torch.mean(x, dim=axes)
        var = torch.var(x, dim=axes, correction=0)
        return mean, torch.reciprocal(torch.sqrt(var + BN_EPS))


WIDTH_CASES = [(c, rows) for c in STAGE1_WIDTHS
               for rows in [(3, 517, 7), (1001,)]] + [(4, (333,)),
                                                       (1024, (2, 333))]


@pytest.mark.cuda
@pytest.mark.parametrize("c,rows", WIDTH_CASES)
def test_bn_relu_forward_is_the_composition(dev, c, rows):
    x, scale, bias, _ = _card_case(dev, rows, c, c)
    mean, inv = _stats(x)
    y = batchnorm.bn_relu_forward_cuda(x, mean, inv, scale, bias)
    torch.cuda.synchronize()
    assert torch.equal(y, torch.relu((x - mean) * inv * scale + bias))


@pytest.mark.cuda
def test_bn_relu_forward_unaligned_input(dev):
    x, scale, bias, _ = _card_case(dev, (777,), 64, 5, offset=1)
    assert x.data_ptr() % 16 != 0
    mean, inv = _stats(x)
    y = batchnorm.bn_relu_forward_cuda(x, mean, inv, scale, bias)
    assert torch.equal(y, torch.relu((x - mean) * inv * scale + bias))


@pytest.mark.cuda
@pytest.mark.parametrize("c,rows", WIDTH_CASES)
def test_bn_relu_backward_matches_autograd(dev, c, rows):
    x, scale, bias, cot = _card_case(dev, rows, c, 100 + c)
    leaves = [t.clone().requires_grad_(True) for t in (x, scale, bias)]
    mean, inv = _stats(x)
    y = batchnorm.bn_relu_train(leaves[0], mean, inv, *leaves[1:])
    got = torch.autograd.grad(y, leaves, cot)
    ref = [t.clone().requires_grad_(True) for t in (x, scale, bias)]
    axes = tuple(range(x.dim() - 1))
    yr = torch.relu((ref[0] - torch.mean(ref[0], dim=axes)) * torch.reciprocal(
        torch.sqrt(torch.var(ref[0], dim=axes, correction=0) + BN_EPS))
        * ref[1] + ref[2])
    assert torch.equal(y.detach(), yr.detach())
    want = torch.autograd.grad(yr, ref, cot)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-5 * float(b.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("c,rows", [(32, (25, 409, 32)), (196, (4001,)),
                                    (1024, (3001,))])
def test_bn_relu_backward_is_deterministic(dev, c, rows):
    x, scale, bias, cot = _card_case(dev, rows, c, 7)
    mean, inv = _stats(x)
    runs = [batchnorm.bn_relu_backward_cuda(cot, x, mean, inv, scale, bias)
            for _ in range(3)]
    for run in runs[1:]:
        for a, b in zip(run, runs[0]):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_bn_relu_backward_is_the_plain_formula(dev):
    x, scale, bias, cot = _card_case(dev, (2001,), 64, 8)
    mean, inv = _stats(x)
    got = batchnorm.bn_relu_backward_cuda(cot, x, mean, inv, scale, bias)
    ref = batchnorm.bn_relu_backward_plain(cot, x, mean, inv, scale, bias)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-5 * float(b.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(None, (1e-4, 1e-5)),
                                       (torch.bfloat16, (1e-2, 1e-2))])
def test_shared_mlp_train_on_card_is_the_composition(dev, dtype, tol):
    """A SharedMLP's fused train step against the same module on the
    composition: the output and the running statistics bit for bit, the
    gradients within f32 rounding (bf16's where the layers are bf16: the
    cotangent of each bf16 Dense output is rounded to bf16, so the sums'
    last bits move whole bf16 steps)."""
    mlp = _randomise(SharedMLP(7, [32, 64, 196], dtype=dtype), 21).to(dev)
    ref = copy.deepcopy(mlp)
    x = torch.randn(4, 257, 16, 7,
                    generator=torch.Generator().manual_seed(22)).to(dev)
    before = dict(_kernels.LAUNCHES)
    out = mlp(x, train=True, bn_momentum=0.05)
    want = _shared_mlp_composition(ref, x, True, 0.05)
    assert torch.equal(out, want)
    assert _states_equal(mlp, ref)
    for a, b in zip(_grads(mlp, out, 23), _grads(ref, want, 23)):
        torch.testing.assert_close(a, b, rtol=tol[0],
                                   atol=tol[1] * float(b.abs().max()))
    assert {k: _kernels.LAUNCHES[k] - before[k] for k in BN_LAUNCHES} == {
        k: 3 for k in BN_LAUNCHES}


@pytest.mark.cuda
def test_bn_relu_counts_one_a_call(dev):
    x, scale, bias, cot = _card_case(dev, (999,), 32, 9)
    mean, inv = _stats(x)
    leaf = x.clone().requires_grad_(True)
    before = dict(_kernels.LAUNCHES)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity
                                            .CPU]):
        ys = [batchnorm.bn_relu_train(leaf, mean, inv, scale, bias)
              for _ in range(3)]
        torch.autograd.grad(sum(torch.sum(y * cot) for y in ys), leaf)
        counters = dict(TRACE.totals()["counters"])
    assert counters["bn_relu.fused"] == 3
    assert {k: _kernels.LAUNCHES[k] - before[k] for k in BN_LAUNCHES} == {
        k: 3 for k in BN_LAUNCHES}


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [((10, 18), torch.float32),
                                         ((10, 1028), torch.float32),
                                         ((64,), torch.float32),
                                         ((10, 64), torch.float64)])
def test_bn_relu_refuses_what_the_kernels_do_not_take(dev, shape, dtype):
    """No path back to the composition on the card: a width the kernels do
    not hold, a 1-d input or another dtype raises, in SharedMLP too."""
    x = torch.randn(shape, device=dev, dtype=dtype)
    c = shape[-1]
    vec = [torch.ones(c, device=dev) for _ in range(4)]
    with pytest.raises(ValueError):
        batchnorm.bn_relu_train(x, *vec)
    if len(shape) == 2 and dtype == torch.float32:
        mlp = SharedMLP(3, [c]).to(dev)
        with pytest.raises(ValueError):
            mlp(torch.randn(2, 5, 3, device=dev), train=True)


@pytest.mark.cuda
def test_global_batch_on_card_is_the_composition(dev):
    """A SharedMLP's step in a global batch of two gloo ranks sharing the
    card (parallel.launch): on each rank the kernels' output and running
    statistics are the composition's bits (BatchNorm's own forward, whose
    statistics all-reduce), and every gradient, the input's too, is the
    composition's within f32 rounding. The kernels' backward all-reduces
    its sums: a rank's gradient taken from its own sums alone would miss
    the other rank's share of dbias and dscale in dx."""
    from torch_parallel_ranks import bn_relu_rank
    from ws3d_tpu_torch.parallel import launch
    mlp = _randomise(SharedMLP(7, [32, 64, 196]), 31)
    g = torch.Generator().manual_seed(32)
    x = torch.randn(4, 301, 8, 7, generator=g)
    w = torch.randn(4, 301, 8, 196, generator=g)
    got = launch(bn_relu_rank, 2, mlp.state_dict(), [32, 64, 196], x, w,
                 backend="gloo", device=str(dev) + ":0", timeout=300)
    for rank in got:
        fused, comp = rank["fused"], rank["composition"]
        assert torch.equal(fused["out"], comp["out"])
        assert all(torch.equal(fused["state"][k], v)
                   for k, v in comp["state"].items())
        for a, b in zip(fused["grads"], comp["grads"]):
            torch.testing.assert_close(a, b, rtol=1e-4,
                                       atol=1e-5 * float(b.abs().max()))
        assert fused["launches"] == {k: 3 for k in BN_LAUNCHES}
        assert comp["launches"] == {k: 0 for k in BN_LAUNCHES}
    assert torch.equal(got[0]["fused"]["state"]["BatchNorm_0.mean"],
                       got[1]["fused"]["state"]["BatchNorm_0.mean"])


@pytest.mark.cuda
def test_rpn_train_forward_takes_34_fused_calls(dev):
    """The stage-1 train forward: 24 SA, 8 FP and 2 head BatchNorms."""
    from ws3d_tpu_torch.config import load_config
    from ws3d_tpu_torch.models import build_model
    cfg = load_config()
    cfg.RPN.NUM_POINTS = 4096
    cfg.RPN.SA_CONFIG.NPOINTS = [1024, 256, 64, 16]
    model = build_model(cfg, device=dev)
    rng = np.random.RandomState(3)
    pts = rng.randn(2, 4096, 4).astype(np.float32) * 5
    pts = pts[:, np.argsort(pts[0, :, 2], kind="stable")]
    before = _kernels.LAUNCHES["bn_relu"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity
                                            .CPU]):
        model.rpn_forward({"pts_input": torch.from_numpy(pts).to(dev)},
                          train=True, generator=torch.Generator(
                              device=dev).manual_seed(0))
        counters = dict(TRACE.totals()["counters"])
    assert counters["bn_relu.fused"] == 34
    assert _kernels.LAUNCHES["bn_relu"] == before + 34


def test_bn_relu_fused_reader():
    """benchmark/metrics/bn_relu.fused.py: the counter over the traced
    steps, None without it."""
    from benchmark import harness
    rec = {"iters": 2}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity
                                            .CPU]):
        pass                                 # no counter
    assert harness.read_metric("rpnpre.bn_relu.fused", rec) is None
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity
                                            .CPU]):
        for _ in range(68):
            count("bn_relu.fused")
    assert harness.read_metric("rpnpre.bn_relu.fused", rec) == 34.0
    assert harness.read_metric("rpn.bn_relu.fused", rec) == 34.0
