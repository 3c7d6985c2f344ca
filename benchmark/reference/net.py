"""The detector's forward pass in plain tensor code: the Pointnet2MSG
backbone with its RPN heads (stage 1), and the stage-2 RCNN trunk with the
IOUN cascade, as functions of a flat parameter dict whose names are the
state-dict names of the measured program and the npz keys of the JAX
package (``rpn.backbone.sa_0.mlp_0.Dense_0.kernel`` is ``params/rpn/
backbone/sa_0/mlp_0/Dense_0/kernel``). Dense kernels are (Cin, Cout).

The layer equations are PointRCNN's (Shi et al., CVPR 2019) as WS3D
(Meng et al., ECCV 2020) configures them: multi-scale set abstraction
(ball query, grouping of [xyz - centre, features], a ReLU MLP, a max over
the samples), feature propagation by 3-NN inverse-distance interpolation,
BatchNorm in stage 1 (eval: running statistics, eps 1e-5) and none in
stage 2, and points z-sorted so that the sampled centres are kept in
ascending index order.

Everything is float32 unless `quant` is given: a function applied to both
factors of every dense product (the lower-precision control of the check
of outputs). Callers turn TF32 off (`f32_matmuls`).
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

from benchmark.reference import ops
from benchmark.reference.box_codec import (bottom_to_center,
                                           center_to_bottom,
                                           decode_box_stage2, refine_box)
from benchmark.reference.boxes import rotate_points_along_y

BN_EPS = 1e-5
EXTEND_FACTOR = 1.2
FP8_MAX = 448.0


@contextlib.contextmanager
def f32_matmuls(tf32: bool = False):
    """Matrix products in full float32 (TF32 off), or with `tf32` in TF32,
    restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor (its largest
    magnitude maps to 448), returned in float32."""
    s = torch.clamp(x.detach().abs().amax(), min=1e-12) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def load_npz(path: str, device) -> Dict[str, torch.Tensor]:
    """{state name: float32 tensor on `device`} from a flat npz of
    params/... and batch_stats/... keys."""
    out = {}
    with np.load(path) as z:
        for key in z.files:
            name = key.split("/", 1)[1].replace("/", ".")
            out[name] = torch.from_numpy(np.asarray(z[key], np.float32)).to(
                device)
    return out


class Net:
    """The forward pass over `params` for configuration `cfg` (a nested
    dict of the configuration file's values)."""

    def __init__(self, params: Dict[str, torch.Tensor], cfg: dict,
                 quant: Optional[Callable] = None):
        self.p = params
        self.cfg = cfg
        self.q = quant or (lambda t: t)
        self.mean_size = torch.tensor(
            [float(v) for v in cfg["CLS_MEAN_SIZE"][0]],
            device=next(iter(params.values())).device)

    # -- layers --------------------------------------------------------
    def dense(self, name: str, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(self.q(x), self.q(self.p[name + ".kernel"]))
        bias = self.p.get(name + ".bias")
        return y if bias is None else y + bias

    def bn(self, name: str, x: torch.Tensor) -> torch.Tensor:
        p = self.p
        inv = torch.rsqrt(p[name + ".var"] + BN_EPS)
        return (x - p[name + ".mean"]) * inv * p[name + ".scale"] + \
            p[name + ".bias"]

    def n_dense(self, prefix: str) -> int:
        n = 0
        while f"{prefix}.Dense_{n}.kernel" in self.p:
            n += 1
        return n

    def mlp(self, prefix: str, h: torch.Tensor) -> torch.Tensor:
        """Dense (+ BatchNorm where the parameters have one) + ReLU."""
        for k in range(self.n_dense(prefix)):
            h = self.dense(f"{prefix}.Dense_{k}", h)
            if f"{prefix}.BatchNorm_{k}.scale" in self.p:
                h = self.bn(f"{prefix}.BatchNorm_{k}", h)
            h = torch.relu(h)
        return h

    def head(self, prefix: str, h: torch.Tensor) -> torch.Tensor:
        """Hidden Dense (+ BatchNorm) + ReLU layers, then a linear one."""
        n = self.n_dense(prefix) - 1
        for k in range(n):
            h = self.dense(f"{prefix}.Dense_{k}", h)
            if f"{prefix}.BatchNorm_{k}.scale" in self.p:
                h = self.bn(f"{prefix}.BatchNorm_{k}", h)
            h = torch.relu(h)
        return self.dense(f"{prefix}.Dense_{n}", h)

    def sa(self, prefix: str, xyz, feats, npoint, radii, nsamples):
        """Multi-scale set abstraction; npoint None groups all points."""
        if npoint is None:
            g = torch.cat([xyz[:, None], feats[:, None]], dim=-1)
            return None, torch.amax(self.mlp(f"{prefix}.mlp_0", g), dim=2)
        idx = torch.sort(ops.fps(xyz, npoint), dim=1).values
        new_xyz = ops.take(xyz, idx)
        outs = []
        for i, (r, s) in enumerate(zip(radii, nsamples)):
            bq = ops.ball_query(r, s, xyz, new_xyz)
            g = torch.cat([ops.take(xyz, bq) - new_xyz[:, :, None],
                           ops.take(feats, bq)], dim=-1)
            outs.append(torch.amax(self.mlp(f"{prefix}.mlp_{i}", g), dim=2))
        return new_xyz, torch.cat(outs, dim=-1)

    # -- stage 1 -------------------------------------------------------
    def rpn(self, pts: torch.Tensor) -> dict:
        """pts (B, N, 4) z-sorted -> rpn_cls (B, N), rpn_reg (B, N, 40)."""
        sa = self.cfg["RPN"]["SA_CONFIG"]
        l_xyz, l_f = [pts[..., 0:3].contiguous()], [pts[..., 3:]]
        for k, npoint in enumerate(sa["NPOINTS"]):
            new_xyz, f = self.sa(f"rpn.backbone.sa_{k}", l_xyz[k], l_f[k],
                                 int(npoint), sa["RADIUS"][k],
                                 sa["NSAMPLE"][k])
            l_xyz.append(new_xyz)
            l_f.append(f)
        for i in range(len(self.cfg["RPN"]["FP_MLPS"]) - 1, -1, -1):
            h = torch.cat([ops.interpolate(l_xyz[i], l_xyz[i + 1],
                                           l_f[i + 1]), l_f[i]], dim=-1)
            l_f[i] = self.mlp(f"rpn.backbone.fp_{i}.SharedMLP_0", h)
        return {"rpn_cls": self.head("rpn.cls_head", l_f[0])[..., 0],
                "rpn_reg": self.head("rpn.reg_head", l_f[0])}

    # -- stage 2 -------------------------------------------------------
    def _stack(self, prefix: str, sa_cfg: dict, xyz, feats):
        for k, npoint in enumerate(sa_cfg["NPOINTS"]):
            npoint = None if int(npoint) == -1 else int(npoint)
            xyz, feats = self.sa(f"{prefix}.sa_{k}", xyz, feats, npoint,
                                 [sa_cfg["RADIUS"][k]],
                                 [sa_cfg["NSAMPLE"][k]])
        return feats                                         # (n, 1, C)

    def _merged(self, prefix: str, suffix: str, pts, raw):
        return self.mlp(f"{prefix}merge_down{suffix}", torch.cat(
            [self.mlp(f"{prefix}xyz_up{suffix}", pts),
             self.mlp(f"{prefix}feature_up{suffix}", raw)], dim=-1))

    def trunk(self, pts, reflect, mask) -> dict:
        """Crops (n, 512, 3), (n, 512, 1), (n, 512, 1) -> rcnn_cls (n,),
        rcnn_reg (n, 52), pred_boxes3d (n, 7) bottom-y in the crop frame
        (decoded from the detached regression)."""
        r = self.cfg["RCNN"]
        n = pts.shape[0]
        merged = self._merged("rcnn.", "", pts, torch.cat([reflect, mask],
                                                          dim=-1))
        f = self._stack("rcnn.sa_stack", r["SA_CONFIG"], pts, merged)
        cls = self.head("rcnn.cls_head", f).reshape(n)
        reg = self.head("rcnn.reg_head", f).reshape(n, -1)
        zero = torch.zeros((n, 3), dtype=reg.dtype, device=reg.device)
        pred = decode_box_stage2(zero, reg.detach(), self.mean_size,
                                 loc_scope=r["LOC_SCOPE"],
                                 loc_bin_size=r["LOC_BIN_SIZE"],
                                 num_head_bin=r["NUM_HEAD_BIN"])
        return {"rcnn_cls": cls, "rcnn_reg": reg, "pred_boxes3d": pred}

    def cascade(self, pts, reflect, mask, pred_boxes3d) -> dict:
        """The IOUN cascade from a trunk box: canonicalise into the box
        frame, zero points beyond EXTEND_FACTOR, stable z re-sort, its own
        up/merge and SA stack, then the IoU, cls and refinement heads."""
        n = pts.shape[0]
        raw = torch.cat([reflect, mask], dim=-1)
        boxes_ce = bottom_to_center(pred_boxes3d)
        out, ref = {}, None
        for c in range(int(self.cfg["CASCADE"])):
            if c:
                boxes_ce = refine_box(boxes_ce, ref)
            canon = rotate_points_along_y(pts - boxes_ce[:, None, 0:3],
                                          boxes_ce[:, 6])
            half = torch.stack([boxes_ce[:, 5], boxes_ce[:, 3],
                                boxes_ce[:, 4]], dim=-1) / 2.0
            canon = canon / torch.clamp(half[:, None, :], min=1e-6)
            gate = torch.amax(torch.abs(canon), dim=-1,
                              keepdim=True) > EXTEND_FACTOR
            canon = torch.where(gate, 0.0, canon)
            order = torch.sort(canon[..., 2], dim=1, stable=True).indices
            canon = torch.gather(canon, 1, order[..., None].expand(-1, -1, 3))
            feats = torch.gather(raw, 1, order[..., None].expand(-1, -1, 2))
            merged = self._merged("rcnn.can_", f"_{c}", canon, feats)
            f = self._stack(f"rcnn.sa_score_{c}",
                            self.cfg["IOUN"]["SA_CONFIG"], canon, merged)
            iou = self.head(f"rcnn.iou_head_{c}", f).reshape(n)
            ref = self.head(f"rcnn.ref_head_{c}", f).reshape(n, 7)
            pred = center_to_bottom(boxes_ce)
            out = {"rcnn_iou": iou, "rcnn_ref": ref, "pred_boxes3d": pred,
                   "refined_box": refine_box(pred, ref)}
        return out


def blocks(n: int, size: int):
    """[lo, hi) ranges of at most `size` covering range(n)."""
    return [(lo, min(lo + size, n)) for lo in range(0, n, size)]


def cat_blocks(fn, n: int, size: int) -> dict:
    """fn(lo, hi) -> dict of tensors, concatenated along axis 0."""
    parts = [fn(lo, hi) for lo, hi in blocks(n, size)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def angle_wrap(ry: torch.Tensor) -> torch.Tensor:
    ry = torch.remainder(ry, 2 * math.pi)
    return torch.where(ry > math.pi, ry - 2 * math.pi, ry)
