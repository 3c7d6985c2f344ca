"""Operations, bytes and the least time of the counted kernel calls, and
the model's FLOPs from the configuration's shapes.

The fused set abstraction (csrc/fused_sa.cu, both entries, every mode):
its ReLU MLP takes 2 * B * M * S * sum(in * out) operations on the tensor
cores, in three TF32 passes (3xTF32) for float32 or one bf16 pass; each
input byte is read once and each output byte written once: xyz, features,
centres, weights and the (B, M, C_last) output in float32. The least time
is the larger of the two. The search's SIMT operations depend on the data
and are left out, so the bound is a lower bound and the share never
counts work the kernel does not need.

Furthest point sampling (csrc/fps.cu): (npoint - 1) * N * 10 float32
operations a row (three differences, three products, two sums, a min and
an argmax step), N * 12 bytes read and npoint * 16 written a row.
"""
from __future__ import annotations

from benchmark.roofline import peaks


def fused_sa_bound_s(note: dict) -> float:
    """note: B, P, C, M, S, widths (C + 3, ..., C_last), bf16."""
    B, P, C, M, S = (note[k] for k in ("B", "P", "C", "M", "S"))
    w = note["widths"]
    mlp = 2 * B * M * S * sum(a * b for a, b in zip(w[:-1], w[1:]))
    weights = sum(a * b + b for a, b in zip(w[:-1], w[1:]))
    nbytes = 4 * (B * P * 3 + B * P * C + B * M * 3 + B * M * w[-1]
                  + weights)
    ops = mlp / peaks.BF16_FLOP_S if note["bf16"] else \
        3 * mlp / peaks.TF32_FLOP_S
    return max(nbytes / peaks.HBM_BYTES_S, ops)


def fps_bound_s(note: dict) -> float:
    """note: R rows, N points, npoint picks."""
    R, N, n = note["R"], note["N"], note["npoint"]
    return max((R * N * 12 + R * n * 16) / peaks.HBM_BYTES_S,
               R * (n - 1) * N * 10 / peaks.F32_FLOP_S)


def _mlp(rows: int, widths) -> int:
    return 2 * rows * sum(a * b for a, b in zip(widths[:-1], widths[1:]))


def rpn_flops(cfg: dict, scenes: int) -> int:
    """FLOPs of stage 1 (every MLP, FP layer and head) for `scenes`."""
    rpn = cfg["RPN"]
    sa = rpn["SA_CONFIG"]
    N = int(rpn["NUM_POINTS"])
    cin = 1 if rpn["USE_INTENSITY"] else 0
    total, c, sizes, skip = 0, cin, [N], [cin]
    for k, npoint in enumerate(sa["NPOINTS"]):
        out = 0
        for s, mlp in zip(sa["NSAMPLE"][k], sa["MLPS"][k]):
            total += _mlp(scenes * npoint * s, [c + 3] + list(mlp))
            out += mlp[-1]
        c = out
        sizes.append(npoint)
        skip.append(c)
    fp = rpn["FP_MLPS"]
    known = skip[-1]
    for i in range(len(fp) - 1, -1, -1):
        total += _mlp(scenes * sizes[i], [known + skip[i]] + list(fp[i]))
        known = fp[i][-1]
    per_loc = int(rpn["LOC_SCOPE"] / rpn["LOC_BIN_SIZE"]) * 2
    for fc, n_out in ((rpn["CLS_FC"], 1), (rpn["REG_FC"], per_loc * 4)):
        total += _mlp(scenes * N, [known] + list(fc) + [n_out])
    return total


def _stack_flops(crops: int, points: int, sa: dict, cin: int) -> int:
    total, c, n = 0, cin, points
    for k, npoint in enumerate(sa["NPOINTS"]):
        rows = crops * (n if npoint == -1 else npoint * sa["NSAMPLE"][k])
        total += _mlp(rows, [c + 3] + list(sa["MLPS"][k]))
        c = sa["MLPS"][k][-1]
        n = npoint
    return total


def _up_flops(crops: int, points: int, up) -> int:
    return (_mlp(crops * points, [3] + list(up))
            + _mlp(crops * points, [2] + list(up))
            + _mlp(crops * points, [2 * up[-1], up[-1]]))


def trunk_flops(cfg: dict, crops: int) -> int:
    """FLOPs of the RCNN trunk (up/merge MLPs, SA stack, cls and reg
    heads) on `crops` crops."""
    r = cfg["RCNN"]
    k = int(r["NUM_POINTS"])
    up = r["XYZ_UP_LAYER"]
    c = r["SA_CONFIG"]["MLPS"][-1][-1]
    per_loc = int(r["LOC_SCOPE"] / r["LOC_BIN_SIZE"]) * 2
    reg = per_loc * 4 + r["NUM_HEAD_BIN"] * 2 + 3 + 1
    return (_up_flops(crops, k, up)
            + _stack_flops(crops, k, r["SA_CONFIG"], up[-1])
            + _mlp(crops, [c] + list(r["CLS_FC"]) + [1])
            + _mlp(crops, [c] + list(r["REG_FC"]) + [reg]))


def cascade_flops(cfg: dict, crops: int) -> int:
    """FLOPs of the IOUN cascade on `crops` crops (every stage)."""
    io = cfg["IOUN"]
    k = int(cfg["RCNN"]["NUM_POINTS"])
    up = cfg["RCNN"]["XYZ_UP_LAYER"]
    c = io["SA_CONFIG"]["MLPS"][-1][-1]
    one = (_up_flops(crops, k, up)
           + _stack_flops(crops, k, io["SA_CONFIG"], up[-1])
           + 2 * _mlp(crops, [c] + list(io["CLS_FC"]) + [1])
           + _mlp(crops, [c] + list(io["REG_FC"]) + [7]))
    return int(cfg["CASCADE"]) * one
