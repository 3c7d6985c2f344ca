"""The segmentation smoke trainer and the legacy modules on the CPU, against
the JAX package: dice_loss (1e-6); one pointnet2_seg step at N = 1,024
(the batch and its box labels exactly, the loss within 1e-5, the
gradients within 2e-3 (see the test), the BN running statistics within
1e-4, Adam's update against optax.adam on the same
gradients within 1e-6); proposal_layer (exact slots, boxes within 1e-6);
roi_target with a shared RandomState (equal draws and selections, floats
within 1e-5: two IoU implementations); the T-Net (1e-4 of the largest magnitude); the tracer's
spans and counters through trace_context."""
import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn
from flax.traverse_util import flatten_dict, unflatten_dict

from torch_port_helpers import n, t
from ws3d_tpu import losses as jax_losses
from ws3d_tpu.config import load_config as jax_load_config
from ws3d_tpu_torch import losses
from ws3d_tpu_torch.config import load_config
from ws3d_tpu_torch.weights import load_variables

N_POINTS, BATCH, LR = 1024, 2, 0.002


def test_dice_loss_matches_jax(rng):
    logits = rng.randn(3, 500, 1).astype(np.float32) * 2
    target = rng.randint(-1, 2, (3, 500)).astype(np.float32)
    for tg in (target, np.clip(target, 0, 1), np.full_like(target, -1)):
        ref = float(jax_losses.dice_loss(jnp.asarray(logits),
                                         jnp.asarray(tg)))
        got = float(losses.dice_loss(t(logits), t(tg)))
        assert abs(got - ref) <= 1e-6


# ------------------------------------------------------------ pointnet2_seg
def _jax_segnet(cfg):
    """The JAX tool's SegNet (tools/pointnet2_seg.py)."""
    from ws3d_tpu.models.backbone import Pointnet2MSG
    from ws3d_tpu.models.layers import HeadMLP

    class SegNet(fnn.Module):
        @fnn.compact
        def __call__(self, pts, train=False):
            _, feats = Pointnet2MSG(
                sa_npoints=cfg.RPN.SA_CONFIG.NPOINTS,
                sa_radius=cfg.RPN.SA_CONFIG.RADIUS,
                sa_nsample=cfg.RPN.SA_CONFIG.NSAMPLE,
                sa_mlps=cfg.RPN.SA_CONFIG.MLPS,
                fp_mlps=cfg.RPN.FP_MLPS, name="backbone")(pts, train=train)
            return HeadMLP(hidden=[128], out_channels=1,
                           name="seg_head")(feats, train=train)
    return SegNet()


@pytest.fixture(scope="module")
def seg_step():
    """One train-mode forward and backward of both packages from the
    port's seeded init (carried to JAX as a variables tree)."""
    from ws3d_tpu.datasets import SyntheticKitti as JaxSynthetic
    from ws3d_tpu.datasets.rpn_dataset import RPNDataset as JaxRPNDataset
    from ws3d_tpu_torch.datasets import RPNDataset, SyntheticKitti
    from ws3d_tpu_torch.models.detector import init_random
    from ws3d_tpu_torch.tools import pointnet2_seg as seg
    from ws3d_tpu_torch.weights import to_flat

    jcfg, tcfg = jax_load_config(), load_config()
    seg.configure(jcfg, N_POINTS)
    seg.configure(tcfg, N_POINTS)
    jds = JaxRPNDataset(JaxSynthetic(num_scenes=4, points_per_scene=18000,
                                     seed=0), jcfg, mode="EVAL",
                        npoints=N_POINTS, seed=0)
    jbatch = next(jds.batches(BATCH))
    tds = RPNDataset(SyntheticKitti(num_scenes=4, points_per_scene=18000,
                                    seed=0), tcfg, mode="EVAL",
                     npoints=N_POINTS, seed=0)
    tbatch = next(seg.seg_batches(tds, BATCH))

    net = init_random(seg.SegNet(tcfg), 0)
    variables = unflatten_dict({tuple(k.split("/")): v
                                for k, v in to_flat(net).items()})
    model = _jax_segnet(jcfg)
    pts = jnp.asarray(jbatch["pts_input"])
    lbl = jnp.clip(jnp.asarray(jbatch["rpn_cls_label"]), 0, 1)

    def loss_fn(p):
        out, mut = model.apply({"params": p,
                                "batch_stats": variables["batch_stats"]},
                               pts, train=True, mutable=["batch_stats"])
        return jax_losses.dice_loss(out, lbl), mut["batch_stats"]
    (loss, stats), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])

    out = net(t(tbatch["pts_input"]), train=True)
    tloss = losses.dice_loss(out, t(tbatch["label"]))
    tloss.backward()
    return dict(jbatch=jbatch, tbatch=tbatch, loss=float(loss),
                tloss=float(tloss.detach()), grads=grads, stats=stats,
                net=net, params=variables["params"], seg=seg)


def test_seg_batch_and_labels_match(seg_step):
    jb, tb = seg_step["jbatch"], seg_step["tbatch"]
    np.testing.assert_array_equal(tb["pts_input"], jb["pts_input"])
    np.testing.assert_array_equal(tb["label"],
                                  np.clip(jb["rpn_cls_label"], 0, 1))
    assert tb["label"].sum() > 0


def test_seg_step_loss_gradients_and_stats_match(seg_step):
    """The Dice loss of a nearly untrained net reads the output through a
    global ratio, and train-mode BN subtracts the batch mean of every
    upstream gradient, so single gradients cancel: JAX's own gradient moves
    by 2.5e-3 to 1.1e-2 (relative L2) when its weights move by 1e-6. The
    gate is therefore global: the relative L2 error over all gradients
    within 2e-3 and every entry within 2e-3 of the largest magnitude."""
    assert abs(seg_step["tloss"] - seg_step["loss"]) <= 1e-5
    ref = {"params/" + "/".join(k): np.asarray(v)
           for k, v in flatten_dict(seg_step["grads"]).items()}
    got = {"params/" + k.replace(".", "/"): n(p.grad)
           for k, p in seg_step["net"].named_parameters()}
    assert got.keys() == ref.keys()
    num = np.sqrt(sum(((got[k] - ref[k]) ** 2).sum() for k in ref))
    den = np.sqrt(sum((ref[k] ** 2).sum() for k in ref))
    assert num <= 2e-3 * den
    gmax = max(np.abs(v).max() for v in ref.values())
    for k in ref:
        assert np.abs(got[k] - ref[k]).max() <= 2e-3 * gmax, k
    stats = {"batch_stats/" + "/".join(k): np.asarray(v)
             for k, v in flatten_dict(seg_step["stats"]).items()}
    buffers = {"batch_stats/" + k.replace(".", "/"): n(b)
               for k, b in seg_step["net"].named_buffers()}
    assert buffers.keys() == stats.keys()
    for k in stats:
        scale = max(float(np.abs(stats[k]).max()), 1.0)
        assert np.abs(buffers[k] - stats[k]).max() <= 1e-4 * scale, k


def test_seg_adam_matches_optax(seg_step):
    seg, net = seg_step["seg"], copy.deepcopy(seg_step["net"])
    params, grads = seg_step["params"], seg_step["grads"]
    tx = optax.adam(LR)

    @jax.jit
    def update(params, state):
        updates, state = tx.update(grads, state)
        return optax.apply_updates(params, updates), state
    state = tx.init(params)
    for _ in range(2):          # two updates: the moments carry over
        params, state = update(params, state)
    opt = seg.make_optimizer(net, LR)
    flat_g = {"/".join(k): np.asarray(v)
              for k, v in flatten_dict(grads).items()}
    for _ in range(2):
        for k, p in net.named_parameters():
            p.grad = t(flat_g[k.replace(".", "/")])
        opt.step()
    ref = {"/".join(k): np.asarray(v)
           for k, v in flatten_dict(params).items()}
    for k, p in net.named_parameters():
        np.testing.assert_allclose(n(p), ref[k.replace(".", "/")],
                                   atol=1e-6, rtol=0, err_msg=k)


def test_seg_cli_runs(tmp_path):
    from ws3d_tpu_torch.tools import pointnet2_seg
    assert pointnet2_seg.main(["--synthetic", "--steps", "2", "--points",
                               "1024", "--batch", "2", "--scenes", "4",
                               "--cpu", "--output_dir", str(tmp_path)]) == 0
    log = (tmp_path / "log.txt").read_text()
    assert "step 0: dice_loss=" in log and "done: final dice_loss=" in log


# ------------------------------------------------------------ proposal_layer
@pytest.mark.parametrize("nms_type", ["rotate", "normal"])
@pytest.mark.parametrize("distance", [False, True])
def test_proposal_fn_matches_jax(rng, nms_type, distance):
    from ws3d_tpu.pipeline.proposal_layer import make_proposal_fn as jax_fn
    from ws3d_tpu_torch.pipeline.proposal_layer import make_proposal_fn
    B, Np = 2, 300
    boxes = np.concatenate([
        rng.uniform(-20, 20, (B, Np, 1)), rng.uniform(-1, 2, (B, Np, 1)),
        rng.uniform(0, 75, (B, Np, 1)), rng.uniform(1.4, 1.7, (B, Np, 1)),
        rng.uniform(1.5, 1.8, (B, Np, 1)), rng.uniform(3.5, 4.5, (B, Np, 1)),
        rng.uniform(-np.pi, np.pi, (B, Np, 1))], -1).astype(np.float32)
    boxes[:, Np // 2:, [0, 2]] = boxes[:, :Np // 2, [0, 2]] + rng.uniform(
        -0.5, 0.5, (B, Np // 2, 2)).astype(np.float32)     # overlapping
    scores = rng.rand(B, Np).astype(np.float32)
    cfgs = []
    for load in (jax_load_config, load_config):
        cfg = load()
        cfg.RPN.NMS_TYPE = nms_type
        cfg.TEST.RPN_PRE_NMS_TOP_N = 128
        cfg.TEST.RPN_POST_NMS_TOP_N = 120
        cfg.TEST.RPN_NMS_THRESH = 0.1
        cfg.TEST.RPN_DISTANCE_BASED_PROPOSE = distance
        cfgs.append(cfg)
    ref = jax.jit(jax_fn(cfgs[0]))(jnp.asarray(scores), jnp.asarray(boxes))
    got = make_proposal_fn(cfgs[1])(t(scores), t(boxes))
    np.testing.assert_array_equal(n(got[2]), np.asarray(ref[2]))
    assert 0 < n(got[2]).sum() < n(got[2]).size
    for g, r in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(n(g), np.asarray(r), atol=1e-6, rtol=0)


# ------------------------------------------------------------ roi_target
def _boxes(rng, m, around=None):
    if around is not None:
        b = around[rng.randint(len(around), size=m)].copy()
        b[:, [0, 2]] += rng.uniform(-0.8, 0.8, (m, 2))
        b[:, 6] += rng.uniform(-0.3, 0.3, m)
        return b.astype(np.float32)
    return np.concatenate([
        rng.uniform(-15, 15, (m, 1)), rng.uniform(1.0, 2.0, (m, 1)),
        rng.uniform(5, 40, (m, 1)), rng.uniform(1.4, 1.7, (m, 1)),
        rng.uniform(1.5, 1.8, (m, 1)), rng.uniform(3.5, 4.5, (m, 1)),
        rng.uniform(-np.pi, np.pi, (m, 1))], -1).astype(np.float32)


def _equal_dicts(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if a[k].dtype == bool:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            np.testing.assert_allclose(a[k], b[k], atol=1e-5, rtol=0,
                                       err_msg=k)


def test_roi_target_matches_jax(rng):
    from ws3d_tpu.pipeline import roi_target as jrt
    from ws3d_tpu_torch.pipeline import roi_target as trt
    gt = _boxes(rng, 5)
    rois = np.concatenate([_boxes(rng, 60, gt), _boxes(rng, 40)])
    for fn in ("sample_rois",):
        a = getattr(trt, fn)(rois, gt, rng=np.random.RandomState(7))
        b = getattr(jrt, fn)(rois, gt, rng=np.random.RandomState(7))
        _equal_dicts(a, b)
        assert 0 < a["is_fg"].sum() < len(a["is_fg"])
    for method in ("single", "multiple", "normal"):
        np.testing.assert_array_equal(
            trt.random_aug_box3d(gt[0], method, np.random.RandomState(3)),
            jrt.random_aug_box3d(gt[0], method, np.random.RandomState(3)))
    for method in (None, "multiple"):
        np.testing.assert_allclose(
            trt.aug_roi_by_noise(rois[0], gt[0], method=method,
                                 rng=np.random.RandomState(5)),
            jrt.aug_roi_by_noise(rois[0], gt[0], method=method,
                                 rng=np.random.RandomState(5)),
            atol=1e-5, rtol=0)
    with pytest.raises(ValueError):
        trt.random_aug_box3d(gt[0], "bogus")
    _equal_dicts(trt.sample_rois_cfg(rois, gt, load_config(),
                                     rng=np.random.RandomState(9)),
                 jrt.sample_rois_cfg(rois, gt, jax_load_config(),
                                     rng=np.random.RandomState(9)))
    empty = trt.sample_rois(rois, gt[:0])
    assert empty["rois"].shape == (32, 7) and not empty["is_fg"].any()


# ------------------------------------------------------------ T-Net
def test_transformer_matches_jax(rng):
    from ws3d_tpu.models.transformer import Transformer as JaxTransformer
    from ws3d_tpu.models.transformer import apply_transform as jax_apply
    from ws3d_tpu_torch.models.transformer import (Transformer,
                                                   apply_transform)
    pts = rng.randn(2, 128, 3).astype(np.float32)
    tnet = Transformer(k=3)
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), (2, 3, 3))
    np.testing.assert_array_equal(n(tnet(t(pts))), eye)   # identity at init
    jnet = JaxTransformer(k=3)
    variables = jax.tree.map(np.asarray, jax.jit(jnet.init)(
        jax.random.PRNGKey(0), jnp.asarray(pts)))
    variables["params"]["fc_out"]["kernel"] = (
        rng.randn(256, 9).astype(np.float32) * 0.01)
    variables["params"]["fc_out"]["bias"] = rng.randn(9).astype(np.float32)
    ref = np.asarray(jnet.apply(variables, jnp.asarray(pts)))
    assert load_variables(tnet, variables) == len(tnet.state_dict())
    got = n(tnet(t(pts)))
    assert np.abs(got - ref).max() <= 1e-4 * max(np.abs(ref).max(), 1.0)
    np.testing.assert_allclose(
        n(apply_transform(t(pts), t(ref))),
        np.asarray(jax_apply(jnp.asarray(pts), jnp.asarray(ref))),
        atol=1e-5, rtol=0)


# ------------------------------------------------------------ profiling
def test_profiling_helpers(tmp_path):
    from ws3d_tpu_torch.utils.profiling import (TRACE, count, span,
                                                trace_context)
    with trace_context(None) as prof:
        assert prof is None
    with span("off"):                          # no profiler: nothing kept
        count("off")
    with trace_context(str(tmp_path / "trace")):
        with span("outer", step=7):
            with span("inner"):
                torch.ones(64, 64) @ torch.ones(64, 64)
            count("items", 8)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert "ws3d::inner" in (tmp_path / "trace" / "trace.json").read_text()
    spans = json.loads((tmp_path / "trace" / "spans.json").read_text())
    inner, outer = spans["spans"]
    assert (inner["name"], outer["name"]) == ("inner", "outer")
    assert inner["parent"] == outer["id"] and inner["step"] == 7
    assert outer["start"] <= inner["start"] < inner["end"] <= outer["end"]
    assert set(spans["totals"]) == {"inner", "outer"}
    assert spans["counters"] == {"items": 8}
    assert TRACE.totals()["counters"] == {"items": 8}
