"""The card tests' tolerances, and their replay of recorded kernel calls.

`Recorder` keeps a copy of the inputs of every kernel call a path makes;
`check_call` replays one against its plain PyTorch version under the gate
named for it here. Every card tolerance is named once, in this module:
tests/test_torch_card_paths.py and tests/test_torch_cuda.py hold the card
to them, and the CPU tests that emulate a kernel's arithmetic
(tests/test_torch_tf32_split.py, tests/test_torch_bf16_fused_sa.py) show
that the emulation sits inside them.

This module imports the port and never JAX: the card's tests run with
`--noconftest` on a machine that may have no JAX.
"""
from __future__ import annotations

import contextlib
import importlib
import os

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "ws3d_tpu", "data", "bench_weights.npz")

# Gates as (abs, rel): max|diff| <= abs + rel * max|ref| (`within`).
# The fused SA's f32 modes (kernels 2 and 3, 3xTF32 on the tensor cores):
# f32 sums over up to 515 terms in another order than the plain matmul.
F32_SA_GATE = (1e-3, 1e-4)
# Kernel 9 (given indices), f32: the same sums over the given rows.
GIVEN_GATE = (1e-6, 1e-4)
# The bf16 modes of kernels 2, 3 and 9 against their plain bf16 versions:
# the same exact products summed in another order can move an activation's
# bf16 rounding by one ulp, so an output may move by one bf16 ulp of the
# largest one; such moves are rare, so the mean distance stays within
# BF16_MEAN_SHARE of the plain version's own mean distance to f32.
BF16_GATE = (1e-3, 2.0 ** -7)
BF16_MEAN_SHARE = 0.1
# Kernels 4 and 8, each element: f32 weighted sums in another order; a
# bf16 store may round to either side, one bf16 ulp (2^-7 of it) more.
INTERP_GATE = (1e-4, 1e-5)
# The BatchNorm + ReLU backward's sums and dx: the same sums in another
# order, or the formula's rounding, relative to max|ref|.
BN_SUMS_REL = 1e-4
# The card's bf16 train step against the CPU's plain bf16 step on a small
# batch: the median over tensors of max|card - CPU| / max|CPU| below
# BF16_GRAD_MEDIAN and below half the CPU's own bf16-vs-f32 median gap;
# BN statistics within BF16_BN_TOL of each tensor's max. The global-batch
# stage-1 step on two ranks against the single step, the same gap: the
# worst tensor within GLOBAL_GRAD_FACTOR times the single step's with its
# BatchNorm sums split as the ranks split them, clamped to
# [GLOBAL_GRAD_WORST_FLOOR (tests/test_torch_parallel_global.py's bound),
# GLOBAL_GRAD_WORST], the median below GLOBAL_GRAD_MEDIAN. Both gaps are
# rounding: the tensor cores' order of f32 sums of bf16 products, and the
# sign of BatchNorm outputs within 1.5e-6 of zero behind the ReLUs (the
# H100 readings are in ROADMAP.md, queue 3).
BF16_GRAD_MEDIAN = {"rpn": 0.15, "rcnn": 0.05, "ioun": 0.05}
BF16_BN_TOL = 5e-3
GLOBAL_GRAD_FACTOR = 2.0
GLOBAL_GRAD_WORST_FLOOR = 1e-3
GLOBAL_GRAD_WORST = 5e-3
GLOBAL_GRAD_MEDIAN = 1e-4

# a plain fused SA of more grouped elements (rows x queries x samples x
# widest layer) than this runs in slices of at most PLAIN_SLICE_ELEMENTS
# (the trunk's 4,096 crops of a batch of 64): the same values, in memory
PLAIN_ROWS_ELEMENTS = 2 ** 31
PLAIN_SLICE_ELEMENTS = 2 ** 29

# the kernel wrappers a Recorder wraps: (module of ws3d_tpu_torch.ops, name)
TARGETS = (("sampling", "fps_cuda"), ("fused_sa", "fused_sa_cuda"),
           ("interpolate", "three_interpolate_cuda"),
           ("crop_gather", "crop_gather_cuda"),
           ("ball_query", "ball_query_multi_cuda"),
           ("interpolate", "three_nn_cuda"),
           ("fused_sa_idx", "fused_sa_idx_cuda"),
           ("ball_query", "ball_query_wrap_cuda"),
           ("interpolate", "three_interpolate_window_cuda"),
           ("nms", "greedy_suppress_cuda"),
           ("batchnorm", "bn_relu_forward_cuda"),
           ("batchnorm", "bn_relu_sums_cuda"),
           ("batchnorm", "bn_relu_dx_cuda"))


def within(err: float, scale: float, gate) -> bool:
    return err <= gate[0] + gate[1] * scale


class Recorder:
    """Wraps each kernel wrapper to keep a copy of the inputs (`calls`:
    (name, args, kwargs)) of every call a path makes and, with `outputs`,
    of its outputs (`outputs`); `only` keeps the wrappers it names."""

    def __init__(self, outputs: bool = False, only=None):
        self.calls, self.outputs, self.keep_outputs = [], [], outputs
        self.targets = [(importlib.import_module(f"ws3d_tpu_torch.ops.{m}"),
                         name) for m, name in TARGETS
                        if only is None or name in only]
        self.saved = {}

    def __enter__(self):
        def keep(a):
            if isinstance(a, torch.Tensor):
                return a.detach().clone()
            if isinstance(a, (list, tuple)):
                return [keep(x) for x in a]
            return a
        for mod, name in self.targets:
            orig = self.saved[(mod, name)] = getattr(mod, name)

            def wrapped(*args, _orig=orig, _name=name, **kw):
                self.calls.append((_name, [keep(a) for a in args], dict(kw)))
                out = _orig(*args, **kw)
                if self.keep_outputs:
                    self.outputs.append(keep(out))
                return out
            setattr(mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for (mod, name), orig in self.saved.items():
            setattr(mod, name, orig)
        return False


def bf16_gate(out, ref, f32, what: str) -> None:
    """The fused SA's bf16 mode against its plain bf16 version `ref` (f32:
    the plain f32 version): BF16_GATE and BF16_MEAN_SHARE."""
    d = (out - ref).abs()
    rounding = (ref - f32).abs().mean().item()
    assert within(d.max().item(), ref.abs().max().item(), BF16_GATE) and \
        d.mean().item() <= BF16_MEAN_SHARE * rounding, (what, d.max().item())


def _rows_plain(fn, xyz, feat, new_xyz, nsample, kernels):
    """fn(xyz, feat, new_xyz), a plain SA whose rows are independent, over
    slices of the rows where one pass would pass PLAIN_ROWS_ELEMENTS."""
    B, M = new_xyz.shape[:2]
    per_row = M * nsample * max([feat.shape[2] + 3]
                                + [int(k.shape[1]) for k in kernels])
    if B * per_row <= PLAIN_ROWS_ELEMENTS:
        return fn(xyz, feat, new_xyz)
    step = max(1, PLAIN_SLICE_ELEMENTS // per_row)
    return torch.cat([fn(xyz[b:b + step], feat[b:b + step],
                         new_xyz[b:b + step]) for b in range(0, B, step)])


def _exact(got, ref, what):
    for a, b in zip(got, ref):
        assert torch.equal(a, b), (what, int((a != b).sum()))


def check_call(name: str, args: list, kw: dict) -> str:
    """Replay one recorded kernel call against its plain version under its
    gate; returns the kernel's key in `_kernels.LAUNCHES`."""
    from ws3d_tpu_torch.ops import (ball_query, batchnorm, crop_gather,
                                    fused_sa, fused_sa_idx, interpolate, nms,
                                    sampling)
    first = args[0] if isinstance(args[0], torch.Tensor) else args[2]
    what = f"{name} {tuple(first.shape)}"

    if name == "bn_relu_forward_cuda":
        assert torch.equal(batchnorm.bn_relu_forward_cuda(*args),
                           batchnorm.bn_relu_plain(*args)), what
        return "bn_relu"
    if name in ("bn_relu_sums_cuda", "bn_relu_dx_cuda"):
        got = getattr(batchnorm, name)(*args)
        ref = getattr(batchnorm, name.replace("_cuda", "_plain"))(*args)
        err = (got - ref).abs().max().item()
        assert err <= BN_SUMS_REL * max(ref.abs().max().item(), 1e-30), \
            (what, err)
        return name[:-len("_cuda")]
    if name == "fps_cuda":
        xyz, npoint = args
        ref = sampling.fps_plain(xyz, npoint)
        _exact(sampling.fps_cuda(xyz, npoint),
               [ref, sampling.gather_points(xyz, ref.long())], what)
        return "fps"
    if name == "fused_sa_cuda":
        xyz, feat, new_xyz, radius, nsample, kernels, biases, window = args
        bf16 = bool(kw.get("bf16"))
        rounded = bf16 and bool(kw.get("round_layers"))
        out = fused_sa.fused_sa_cuda(*args, **kw)

        def plain(b16=bf16, r=rounded):
            return _rows_plain(lambda x, f, q: fused_sa.fused_sa_plain(
                x, f, q, radius, nsample, kernels, biases, b16, r),
                xyz, feat, new_xyz, nsample, kernels)
        ref = plain()
        if bf16:
            bf16_gate(out, ref, plain(False, False), what)
        else:
            err = (out - ref).abs().max().item()
            assert within(err, ref.abs().max().item(), F32_SA_GATE), \
                (what, err)
        # each layer rounded: the outputs are bf16 values
        assert not rounded or torch.equal(out, out.bfloat16().float()), what
        return ("fused_sa_window" if window else "fused_sa_full") + (
            "_bf16r" if rounded else "_bf16" if bf16 else "")
    if name == "three_interpolate_cuda":
        # the forward's workspace, if it passed one, is left out: a call
        # here allocates its own, as the forward does
        args = args[:3]
        b16 = bool(kw.get("bf16_out"))
        out = interpolate.three_interpolate_cuda(*args, bf16_out=b16)
        ref = interpolate.three_interpolate_plain(*args, bf16_out=b16).float()
        tol = INTERP_GATE[0] + INTERP_GATE[1] * ref.abs().max().item()
        d = (out.float() - ref).abs()
        assert not bool((d > tol + (2.0 ** -7 * ref.abs() if b16 else 0.0))
                        .any()), (what, d.max().item())
        # the bf16 store is the f32 result rounded to nearest even, bit for
        # bit (a truncating store, or one that rounds the weights or the
        # features first, differs)
        assert not b16 or torch.equal(out, interpolate.three_interpolate_cuda(
            *args).bfloat16()), what
        return "three_interpolate_bf16" if b16 else "three_interpolate"
    if name == "crop_gather_cuda":
        # (xyz, channels, centers, radius, k, grouped, z_window)
        *cargs, z_window = list(args) + [
            kw.get(n, d) for n, d in (("grouped", True),
                                      ("z_window", None))][len(args) - 5:]
        ref = (crop_gather.crop_gather_plain(*cargs) if z_window is None
               else crop_gather.crop_gather_window_plain(*cargs, z_window))
        _exact(crop_gather.crop_gather_cuda(*cargs, z_window)[::-1],
               ref[::-1], what)
        return "crop_gather" if z_window is None else "crop_gather_window"
    if name == "ball_query_wrap_cuda":
        idx, cnt = ball_query.ball_query_wrap_cuda(*args)
        ridx, rcnt = ball_query.ball_query_wrap_plain(*args)
        _exact(idx + cnt, ridx + rcnt, what)
        return "ball_query_wrap"
    if name == "three_interpolate_window_cuda":
        args = args[:3]                     # as three_interpolate_cuda's
        out, d2, idx = interpolate.three_interpolate_window_cuda(
            *args, with_nn=True)
        rd2, ridx, _ = interpolate.window_search(*args[:2])
        kd2, kidx = interpolate.three_nn_cuda(*args[:2])         # kernel 7
        _exact([idx, idx, d2, d2], [ridx.int(), kidx, rd2, kd2], what)
        # kernel 4's arithmetic on the same neighbours: bit-equal
        assert torch.equal(out, interpolate.three_interpolate_cuda(*args)), \
            what
        ref = interpolate.three_interpolate_window_plain(*args)
        err = (out - ref).abs().max().item()
        assert within(err, ref.abs().max().item(), INTERP_GATE), (what, err)
        return "three_interpolate_window"
    if name == "ball_query_multi_cuda":
        _exact(ball_query.ball_query_multi_cuda(*args),
               ball_query.ball_query_multi_plain(*args), what)
        return "ball_query"
    if name == "three_nn_cuda":
        _exact(interpolate.three_nn_cuda(*args),
               interpolate.three_nn_plain(*args[:2]), what)
        return "three_nn"
    if name == "fused_sa_idx_cuda":
        xyz, feat, new_xyz, idx, kernels, biases = args
        bf16 = bool(kw.get("bf16"))
        out = fused_sa_idx.fused_sa_idx_cuda(*args, **kw)
        ref = fused_sa_idx.fused_sa_idx_plain(idx, xyz, feat, new_xyz,
                                              kernels, biases, bf16)
        if bf16:
            bf16_gate(out, ref, fused_sa_idx.fused_sa_idx_plain(
                idx, xyz, feat, new_xyz, kernels, biases), what)
        else:
            err = (out - ref).abs().max().item()
            assert within(err, ref.abs().max().item(), GIVEN_GATE), \
                (what, err)
        return "fused_sa_idx_bf16" if bf16 else "fused_sa_idx"
    if name == "greedy_suppress_cuda":
        assert torch.equal(nms.greedy_suppress_cuda(*args),
                           nms.greedy_suppress_plain(*args)), what
        return "greedy_sweep"
    raise KeyError(name)


def check_calls(calls) -> dict:
    """check_call on each recorded call: {kernel key: calls}."""
    keys = {}
    with torch.no_grad():
        for name, args, kw in calls:
            key = check_call(name, args, kw)
            keys[key] = keys.get(key, 0) + 1
    return keys


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms: index_add_ and the gather
    backward sum without atomics, so two runs of one step from one state
    agree bitwise (otherwise the atomics' order can move a near-zero
    gradient's sign, which Adam's first step turns into a whole lr).
    cuBLAS needs its workspace setting for that mode."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


@contextlib.contextmanager
def split_bn_sums(parts: int = 2):
    """BatchNorm's batch statistics summed as `parts` ranks of a global
    batch sum them (parallel.global_batch.mean_var at W = parts), in one
    process: the sums over `parts` equal slices of the batch axis added in
    turn, over the whole count, for the mean and then for the squared
    deviations from it. Swaps global_batch.mean_var while it is open."""
    from ws3d_tpu_torch.parallel import global_batch

    def mean_var(x):
        axes = tuple(range(x.dim() - 1))
        edges = [i * (x.shape[0] // parts) for i in range(parts)]
        count = x.numel() // x.shape[-1]

        def summed(t):
            out = None
            for a, b in zip(edges, edges[1:] + [x.shape[0]]):
                s = torch.sum(t[a:b], dim=axes)
                out = s if out is None else out + s
            return out
        mean = summed(x) / count
        d = x - mean
        return mean, summed(d * d) / count

    saved, global_batch.mean_var = global_batch.mean_var, mean_var
    try:
        yield
    finally:
        global_batch.mean_var = saved


def gap(a, ref) -> float:
    """max |a - ref| over max |ref| (0.0 where ref is all zeros)."""
    scale = ref.abs().max().item()
    return (a - ref).abs().max().item() / scale if scale else 0.0


def grad_gaps(got: dict, ref: dict) -> tuple:
    """(the worst tensor's gap, the median gap) of `got` against `ref`."""
    gaps = [gap(got[k], g) for k, g in ref.items()]
    return max(gaps), float(np.median(gaps))


def check_detections(a: dict, b: dict, score_thresh: float) -> None:
    """One scene's detections: the same spill, and every kept box on one
    side has a kept box on the other within 0.05 m (centre) and 0.02
    (score), unless its score lies within 0.02 of the threshold."""
    assert int(a["spilled"]) == int(b["spilled"])
    for x, y in ((a, b), (b, a)):
        kx, ky = x["keep"][0], y["keep"][0]
        bx, by = x["boxes"][0][kx], y["boxes"][0][ky]
        sx, sy = x["scores"][0][kx], y["scores"][0][ky]
        for i in range(bx.shape[0]):
            if by.shape[0]:
                d = torch.linalg.norm(by[:, [0, 2]] - bx[i, [0, 2]], dim=-1)
                j = int(torch.argmin(d))
                if d[j] < 0.05 and abs(float(sy[j] - sx[i])) < 0.02:
                    continue
            assert abs(float(sx[i]) - score_thresh) < 0.02, bx[i]


def check_txt(a, b, score_thresh: float, tol: float = 1e-3) -> None:
    """check_detections's rule on two KITTI result files' rows, matched as
    the diff tool matches them, within `tol` in centre and score."""
    from ws3d_tpu_torch.tools.diff_detections import match
    pairs = match(a, b)
    for i, j in pairs:
        assert float(np.linalg.norm(a[i, 7:10] - b[j, 7:10])) <= tol and \
            abs(float(a[i, 11] - b[j, 11])) <= tol, (a[i], b[j])
    for rows, done in ((a, {i for i, _ in pairs}), (b, {j for _, j in pairs})):
        assert all(k in done or abs(rows[k, 11] - score_thresh) < 0.02
                   for k in range(len(rows)))


def check_records(a: list, b: list) -> None:
    """The same proposal-database records: keys, types, dtypes, shapes and
    integers equal, floats within 1e-5."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k, u in x.items():
            v = y[k]
            assert type(u) is type(v), k
            if not isinstance(u, np.ndarray):
                assert u == v, k
                continue
            assert (u.dtype, u.shape) == (v.dtype, v.shape), k
            assert not u.size or np.abs(
                u.astype(np.float64) - v).max() <= 1e-5, k
