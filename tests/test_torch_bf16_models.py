"""The port's networks with cfg.TPU.COMPUTE_DTYPE=bfloat16 against the JAX
package's at bf16, full widths, the fitted npz, N = 2048 (NPOINTS 512, 128,
32, 8), and bf16 training through the entry points that used to refuse
it.

Rounding models (the port's fused SA rounds as JAX's XLA bf16 path does,
bf16 factors of the centre-relative rows and f32 sums, not as the TPU's
fused SA kernels round layer 0; its FP fold and interpolation round as the
TPU's kernels do; see models/pointnet2.py and ROADMAP.md queue 3):
- Stage 1 is held against the JAX package with FORCE_FP_FOLD (the TPU's FP
  fold: bf16 factors, f32 results); its SA stages take JAX's XLA bf16 path.
  The TPU's fused SA kernels are not patched in here: they round layer 0's
  pre-activations [xyz, feat] @ W0, which carry absolute coordinates (tens
  of metres), to bf16 and move rpn_cls by 1.39 of max 4.08 against f32 at
  this size, where the XLA bf16 path moves it by 0.059 and the port by
  0.044 (the port's bf16 mode rounds the centre-relative rows instead; the
  kernels themselves are held against the port's plain versions in
  tests/test_torch_bf16_fused_sa.py). Tolerance: max|diff| <= 5e-2 of the
  f32 output's max|x| (bf16 roundings through ~20 layers: measured 2.4-2.7
  %), and the port's bf16 no farther from f32 than 1.5x JAX's bf16 is
  from JAX's f32 (measured 0.75-0.83x).
- Stage 2 (crop-local coordinates) is held against the JAX package with
  FORCE_FUSED_INTERPRET (the TPU's fused SA kernels in interpret mode) and
  against its XLA bf16 path: max|diff| <= 1e-2 of the f32 output's max|x|
  (measured at most 0.6 %).
- FPS picks depend on xyz alone and are equal exactly."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ws3d_tpu.models.pointnet2 as jp2
from torch_port_helpers import WEIGHTS, n, small_cfg, synthetic_batch, t
from ws3d_tpu.config import load_config as jax_load_config
from ws3d_tpu.models import build_model as jax_build, init_model
from ws3d_tpu.pipeline.inference import crop_for_rcnn_batched, rpn_propose
from ws3d_tpu.utils.npz_overlay import overlay_flat_npz
from ws3d_tpu_torch.config import compute_dtype, load_config
from ws3d_tpu_torch.models import build_model
from ws3d_tpu_torch.weights import load_npz

N, NPOINTS = 2048, (512, 128, 32, 8)


def _jax(dtype):
    cfg = small_cfg(jax_load_config, N, NPOINTS)
    cfg.TPU.COMPUTE_DTYPE = dtype
    model = jax_build(cfg)
    variables = init_model(model, cfg, jax.random.PRNGKey(0))
    variables, _, _ = overlay_flat_npz(variables, WEIGHTS)
    return model, variables, cfg


def _port(dtype):
    cfg = small_cfg(load_config, N, NPOINTS)
    cfg.TPU.COMPUTE_DTYPE = dtype
    model = build_model(cfg, device="cpu")
    load_npz(model, WEIGHTS)
    return model


def _apply(model, variables, method, batch, **kw):
    return jax.jit(lambda v, b: model.apply(v, b, train=False,
                                            method=getattr(model, method),
                                            **kw))(variables, batch)


@pytest.fixture(scope="module")
def stage1():
    pts = synthetic_batch(2, N)
    jb, vb, _ = _jax("bfloat16")
    jf, vf, cfg = _jax("float32")
    batch = {"pts_input": jnp.asarray(pts)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jp2, "FORCE_FP_FOLD", True)
        ref = {k: np.asarray(v) for k, v in _apply(
            jb, vb, "rpn_forward", batch).items()}
    inter = jax.jit(lambda v, b: jb.apply(
        v, b, train=False, method=jb.rpn_forward, mutable=["intermediates"],
        capture_intermediates=lambda m, _: str(m.name).startswith("sa_")))(
        vb, batch)[1]["intermediates"]["rpn"]["backbone"]
    picks = [np.asarray(inter[f"sa_{k}"]["__call__"][0][0]) for k in range(4)]
    f32 = {k: np.asarray(v) for k, v in _apply(jf, vf, "rpn_forward",
                                                batch).items()}
    port = _port("bfloat16")
    got_picks = []
    hooks = [getattr(port.rpn.backbone, f"sa_{k}").register_forward_hook(
        lambda m, i, o: got_picks.append(n(o[0]))) for k in range(4)]
    with torch.no_grad():
        got = {k: n(v) for k, v in port.rpn_forward(
            {"pts_input": t(pts)}).items()}
        got_f32 = {k: n(v) for k, v in _port("float32").rpn_forward(
            {"pts_input": t(pts)}).items()}
    for h in hooks:
        h.remove()
    return dict(pts=pts, cfg=cfg, ref=ref, f32=f32, got=got, got_f32=got_f32,
                picks=picks, got_picks=got_picks)


def test_stage1_fps_picks_equal(stage1):
    assert len(stage1["got_picks"]) == 4
    for a, b in zip(stage1["got_picks"], stage1["picks"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(stage1["got"]["backbone_xyz"],
                                  stage1["ref"]["backbone_xyz"])


@pytest.mark.parametrize("key", ["rpn_cls", "rpn_reg", "backbone_features"])
def test_stage1_bf16_matches_jax(stage1, key):
    got, ref, f32 = stage1["got"][key], stage1["ref"][key], stage1["f32"][key]
    assert got.dtype == ref.dtype == np.float32
    scale = float(np.abs(f32).max())
    err = float(np.abs(got - ref).max())
    assert err <= 5e-2 * scale, (err, scale)
    port_f32 = float(np.abs(got - stage1["got_f32"][key]).max())
    jax_f32 = float(np.abs(ref - f32).max())
    assert 0 < port_f32 <= 1.5 * jax_f32, (port_f32, jax_f32)


@pytest.fixture(scope="module")
def stage2(stage1):
    """Crops from the JAX package's own f32 proposals and crop step."""
    cfg, f32 = stage1["cfg"], stage1["f32"]
    centers = jax.vmap(lambda c, r, x: rpn_propose(
        c, r, x, cfg.RPN.LOC_SCOPE, cfg.RPN.LOC_BIN_SIZE,
        score_thresh=cfg.RPN.SCORE_THRESH, max_proposals=8)[0])(
        f32["rpn_cls"], f32["rpn_reg"], f32["backbone_xyz"])
    cr, _ = crop_for_rcnn_batched(jnp.asarray(stage1["pts"]),
                                  jax.nn.sigmoid(f32["rpn_cls"][..., 0]),
                                  centers, num_sampled=512)
    crops = {k: np.asarray(v).reshape((-1,) + v.shape[2:])
             for k, v in cr.items()}
    jc = {k: jnp.asarray(v) for k, v in crops.items()}
    jb, vb, _ = _jax("bfloat16")
    jf, vf, _ = _jax("float32")
    trunk_f32 = _apply(jf, vf, "rcnn_trunk_forward", jc)
    boxes = np.asarray(trunk_f32["pred_boxes3d"])
    casc = dict(jc, pred_boxes3d=jnp.asarray(boxes))
    port = _port("bfloat16")
    tc = {k: t(v) for k, v in crops.items()}

    def run(trunk_fn, casc_fn):
        # the cascade runs from the f32 trunk's boxes; its pred_boxes3d
        # echoes them, so the trunk's is kept
        return {**trunk_fn(), **{k: v for k, v in casc_fn().items()
                                 if k != "pred_boxes3d"}}
    out = {"f32": run(lambda: trunk_f32,
                      lambda: _apply(jf, vf, "ioun_forward", casc)),
           "xla": run(lambda: _apply(jb, vb, "rcnn_trunk_forward", jc),
                      lambda: _apply(jb, vb, "ioun_forward", casc))}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jp2, "FORCE_FUSED_INTERPRET", True)
        out["tpu"] = run(lambda: _apply(jb, vb, "rcnn_trunk_forward", jc),
                         lambda: _apply(jb, vb, "ioun_forward", casc))
    with torch.no_grad():
        out["port"] = run(lambda: port.rcnn_trunk_forward(tc),
                          lambda: port.ioun_forward(
                              dict(tc, pred_boxes3d=t(boxes))))
    return {side: {k: n(v) if isinstance(v, torch.Tensor) else np.asarray(v)
                   for k, v in d.items()} for side, d in out.items()}


@pytest.mark.parametrize("key", ["rcnn_cls", "rcnn_reg", "pred_boxes3d",
                                 "rcnn_iou", "ioun_cls", "rcnn_ref",
                                 "refined_box"])
@pytest.mark.parametrize("side", ["tpu", "xla"])
def test_stage2_bf16_matches_jax(stage2, key, side):
    got, ref, f32 = (stage2["port"][key], stage2[side][key],
                     stage2["f32"][key])
    assert got.dtype == ref.dtype == np.float32
    scale = float(np.abs(f32).max())
    assert scale > 0
    assert float(np.abs(got - ref).max()) <= 1e-2 * scale
    assert float(np.abs(got - f32).max()) > 0       # bf16 rounds


def test_bf16_modules_keep_f32_parameters():
    port = _port("bfloat16")
    assert {p.dtype for p in port.parameters()} == {torch.float32}
    assert {b.dtype for b in port.buffers()} == {torch.float32}
    rc = port.rcnn
    assert rc.xyz_up.out_f32 is False and rc.merge_down.out_f32 is False
    assert rc.can_merge_down_0.out_f32 is False
    assert rc.iou_head_0.Dense_0.dtype is None      # the IOUN heads: f32
    assert rc.cls_head.Dense_0.dtype == torch.bfloat16


def test_compute_dtype_names():
    cfg = load_config()
    assert compute_dtype(cfg) is None
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    assert compute_dtype(cfg) == torch.bfloat16
    cfg.TPU.COMPUTE_DTYPE = "float16"
    with pytest.raises(ValueError, match="float16"):
        compute_dtype(cfg)
    with pytest.raises(ValueError):
        build_model(cfg, device="cpu")


def _floats_are_f32(state) -> bool:
    """Every floating tensor in a (nested) checkpoint payload is f32."""
    if isinstance(state, torch.Tensor):
        return not state.is_floating_point() or state.dtype == torch.float32
    if isinstance(state, dict):
        return all(_floats_are_f32(v) for v in state.values())
    if isinstance(state, (list, tuple)):
        return all(_floats_are_f32(v) for v in state)
    return True


def _logged_losses(log_path) -> list:
    import re
    text = open(log_path).read()
    return [float(v) for v in re.findall(r" loss=([-\w.]+)", text)]


def test_bf16_training_runs(tmp_path):
    """The calls that refused bf16 until the bf16 backward was ported now
    train: both loss functions, the Trainer, the BN-free SA stack in train
    mode and both training tools with --set TPU.COMPUTE_DTYPE=bfloat16 on
    the CPU. Losses are finite; parameters, optimizer state and the saved
    checkpoints stay f32, as flax keeps them."""
    import math

    from torch_port_helpers import (stage2_batch, torch_stage2_model,
                                    train_batch)
    from ws3d_tpu_torch.tools import train_cascade, train_rpn
    from ws3d_tpu_torch.training import Trainer
    from ws3d_tpu_torch.training.trainer import (batch_to_device,
                                                 make_rcnn_loss_fn,
                                                 make_rpn_loss_fn,
                                                 step_inputs)
    port = _port("bfloat16")
    cfg = copy.deepcopy(small_cfg(load_config, N, NPOINTS))
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    cfg.RPN.DP_RATIO = 0.0
    gen = torch.Generator().manual_seed(0)
    batch = train_batch(2, N)
    total, _ = make_rpn_loss_fn(port, cfg)(batch_to_device(batch, "cpu"), gen,
                                           0.1)
    total.backward()
    assert math.isfinite(float(total.detach()))
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               for p in port.rpn.parameters())

    trainer = Trainer(port, cfg, total_steps=1)
    hist = trainer.train_steps([batch], total_steps=1, log_every=1,
                               prefetch_size=0)
    assert math.isfinite(hist[0]["loss"])
    assert _floats_are_f32(trainer.optimizer.state_dict())
    assert all(p.dtype == torch.float32 for p in port.parameters())

    model, scfg = torch_stage2_model("ioun", dtype="bfloat16")
    crops = stage2_batch("ioun")
    total, _ = make_rcnn_loss_fn(model, scfg, "ioun")(
        batch_to_device(crops, "cpu", step_inputs("ioun", crops)), gen, 0.1)
    assert math.isfinite(float(total.detach()))
    crop = torch.randn((2, 128, 3), generator=gen)
    feats = torch.randn((2, 128, 128), generator=gen).to(torch.bfloat16)
    out = model.rcnn.sa_stack(crop, feats.requires_grad_(True), train=True)
    out.float().sum().backward()
    assert torch.isfinite(out.float()).all()
    assert feats.grad is not None and feats.grad.dtype == torch.bfloat16
    for tool, extra, name in (
            (train_rpn, ["--points", "512", "--batch", "2", "--scenes", "4",
                         "--val_scenes", "2", "--val_every", "1"], "rpn"),
            (train_cascade, ["--stage", "rcnn", "--batch", "8",
                             "--npoints", "128", "--db_size", "16",
                             "--val_every", "1"], "rcnn")):
        out_dir = tmp_path / tool.__name__.rsplit(".", 1)[-1]
        assert tool.main(["--synthetic", "--steps", "1", "--device", "cpu",
                          "--output_dir", str(out_dir),
                          "--set", "TPU.COMPUTE_DTYPE=bfloat16"] + extra) == 0
        losses = _logged_losses(out_dir / "log.txt")
        assert losses and all(math.isfinite(v) for v in losses), losses
        ckpt = torch.load(out_dir / f"{name}_ckpt.pt", weights_only=True)
        assert _floats_are_f32(ckpt["model"])
        assert _floats_are_f32(ckpt["optimizer"])
