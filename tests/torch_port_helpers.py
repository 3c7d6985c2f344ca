"""Shared helpers for the tests that hold ws3d_tpu_torch against ws3d_tpu.

Both packages get the same inputs, made with numpy from a seed; JAX runs on
the CPU (tests/conftest.py) and the port on CPU tensors, where every kernel
wrapper runs its plain PyTorch version.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from torch_card_helpers import REPO, WEIGHTS  # noqa: F401

# six xdist workers share the machine
torch.set_num_threads(2)


def t(a) -> torch.Tensor:
    """numpy / jax array -> CPU torch tensor (a copy)."""
    return torch.from_numpy(np.array(a))


def n(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def small_cfg(load_config, n_points: int = 4096,
              npoints=(1024, 256, 64, 16)):
    """Full widths, a small cloud (either package's load_config)."""
    cfg = load_config()
    cfg.RCNN.ENABLED = True
    cfg.IOUN.ENABLED = True
    cfg.RPN.NUM_POINTS = n_points
    cfg.RPN.SA_CONFIG.NPOINTS = list(npoints)
    return cfg


@functools.lru_cache(maxsize=None)
def jax_detector(n_points: int = 4096, npoints=(1024, 256, 64, 16)):
    """(model, variables with the fitted npz, cfg) of the JAX package."""
    import jax
    from ws3d_tpu.config import load_config
    from ws3d_tpu.models import build_model, init_model
    from ws3d_tpu.utils.npz_overlay import overlay_flat_npz
    cfg = small_cfg(load_config, n_points, npoints)
    model = build_model(cfg)
    variables = init_model(model, cfg, jax.random.PRNGKey(0))
    variables, _, _ = overlay_flat_npz(variables, WEIGHTS)
    return model, variables, cfg


@functools.lru_cache(maxsize=None)
def torch_detector(n_points: int = 4096, npoints=(1024, 256, 64, 16)):
    """(model with the fitted npz on the CPU, cfg) of the port."""
    from ws3d_tpu_torch.config import load_config
    from ws3d_tpu_torch.models import build_model
    from ws3d_tpu_torch.weights import load_npz
    cfg = small_cfg(load_config, n_points, npoints)
    model = build_model(cfg, device="cpu")
    load_npz(model, WEIGHTS)
    return model, cfg


def rpn_cfg(load_config, n_points: int = 2048, dtype: str = "float32"):
    """Stage 1 alone at full widths on a small cloud, NPOINTS scaled as
    tools/train_rpn.py scales them, no dropout, TPU.COMPUTE_DTYPE `dtype`
    (either package's load_config)."""
    cfg = load_config()
    cfg.TPU.COMPUTE_DTYPE = dtype
    cfg.RPN.NUM_POINTS = n_points
    cfg.RPN.SA_CONFIG.NPOINTS = [n_points // 4, n_points // 16,
                                 n_points // 64, n_points // 256]
    cfg.RPN.DP_RATIO = 0.0
    return cfg


@functools.lru_cache(maxsize=None)
def rpn_flat_weights():
    """The fitted npz's stage-1 entries ({npz key: array})."""
    with np.load(WEIGHTS) as z:
        return {k: z[k] for k in z.files if k.split("/")[1] == "rpn"}


def train_batch(n_scenes: int, n_points: int, seed: int = 3):
    """A TRAIN batch (shuffled, augmented, Gaussian labels) of the JAX
    package's loader."""
    from ws3d_tpu.config import load_config
    from ws3d_tpu.datasets import SyntheticKitti
    from ws3d_tpu.datasets.rpn_dataset import RPNDataset
    src = SyntheticKitti(num_scenes=2 * n_scenes, points_per_scene=20000,
                         seed=seed)
    ds = RPNDataset(src, load_config(), mode="TRAIN", npoints=n_points,
                    seed=0)
    return next(ds.batches(batch_size=n_scenes, steps=1))


def synthetic_batch(n_scenes: int, n_points: int, seed: int = 3):
    """EVAL pts_input (B, N, 4) of the JAX package's loader."""
    from ws3d_tpu.config import load_config
    from ws3d_tpu.datasets import SyntheticKitti
    from ws3d_tpu.datasets.rpn_dataset import RPNDataset
    cfg = load_config()
    src = SyntheticKitti(num_scenes=n_scenes, points_per_scene=20000,
                         seed=seed)
    ds = RPNDataset(src, cfg, mode="EVAL", npoints=n_points, seed=0)
    return next(ds.batches(batch_size=n_scenes, steps=1,
                           shuffle=False))["pts_input"]


def two_stage_pair(pts, max_proposals: int, rcnn_budget: int,
                   ioun_budget: int):
    """make_two_stage_fn of both packages on `pts` with the given stage-2
    budgets (on copies of the cached configs) -> (ref, got) numpy dicts."""
    import copy
    import jax
    import jax.numpy as jnp
    from ws3d_tpu.pipeline import make_two_stage_fn as jax_two_stage
    from ws3d_tpu_torch.pipeline import make_two_stage_fn
    jmodel, variables, jcfg = jax_detector()
    tmodel, tcfg = torch_detector()
    jcfg, tcfg = copy.deepcopy(jcfg), copy.deepcopy(tcfg)
    for cfg in (jcfg, tcfg):
        cfg.TPU.RCNN_BUDGET_PER_SCENE = rcnn_budget
        cfg.TPU.IOUN_BUDGET_PER_SCENE = ioun_budget
    ref = jax.jit(jax_two_stage(jmodel, jcfg, max_proposals=max_proposals))(
        variables, jnp.asarray(pts))
    got = make_two_stage_fn(tmodel, tcfg, max_proposals=max_proposals)(t(pts))
    return ({k: np.asarray(v) for k, v in ref.items()},
            {k: n(v) for k, v in got.items()})


def assert_compacted_match(ref, got, atol: float = 1e-3):
    """Equal `spilled` (> 0, so the budget really cut) and `n_live`, the
    same proposal slots and keep set, live boxes/scores within `atol`."""
    assert int(ref["spilled"]) > 0, "fixture should overflow the budget"
    assert int(got["spilled"]) == int(ref["spilled"])
    assert int(got["n_live"]) == int(ref["n_live"])
    np.testing.assert_array_equal(got["proposal_valid"],
                                  ref["proposal_valid"])
    assert ref["keep"].any()
    np.testing.assert_array_equal(got["keep"], ref["keep"])
    live = ref["proposal_valid"]
    np.testing.assert_allclose(got["boxes"][live], ref["boxes"][live],
                               atol=atol, rtol=1e-4)
    np.testing.assert_allclose(got["scores"][live], ref["scores"][live],
                               atol=atol, rtol=1e-4)
    assert got["packed"].shape == ref["packed"].shape


def sorted_cloud(rng, B, P, C, spread=3.0):
    """Points sorted ascending by z, features in [0, 1)."""
    xyz = rng.randn(B, P, 3).astype(np.float32) * spread
    xyz = xyz[np.arange(B)[:, None], np.argsort(xyz[..., 2], axis=1,
                                                  kind="stable")]
    return xyz, rng.rand(B, P, C).astype(np.float32)


def random_mlp(rng, cin, widths):
    kernels, biases = [], []
    for w in widths:
        kernels.append(rng.randn(cin, w).astype(np.float32) * 0.3)
        biases.append(rng.randn(w).astype(np.float32) * 0.1)
        cin = w
    return kernels, biases


def stage2_cfg(load_config, stage: str, npoints: int = 128,
               dtype: str = "float32"):
    """The stage-2 config of `stage` at `npoints`-point crops, NPOINTS
    scaled as tools/train_cascade.py scales them, TPU.COMPUTE_DTYPE `dtype`
    (either package's load_config)."""
    from ws3d_tpu_torch.tools.train_cascade import configure
    cfg = load_config()
    configure(cfg, stage, npoints)
    cfg.TPU.COMPUTE_DTYPE = dtype
    return cfg


@functools.lru_cache(maxsize=None)
def stage2_flat_weights(with_cascade: bool):
    """Stage-2 weights as flat npz entries ({npz key: array}): the fitted
    npz's trunk and, if `with_cascade`, a cascade drawn by the port's
    init_random (seed 0). The fitted cascade is dead below SA1's last layer
    on the training crops (every ReLU there is off), so its gradients would
    test nothing."""
    from ws3d_tpu_torch.config import load_config
    from ws3d_tpu_torch.models import build_model
    from ws3d_tpu_torch.training.trainer import CASCADE_PREFIXES
    from ws3d_tpu_torch.weights import to_flat
    with np.load(WEIGHTS) as z:
        flat = {k: z[k] for k in z.files if k.split("/")[1] == "rcnn"
                and not k.split("/")[2].startswith(CASCADE_PREFIXES)}
    if with_cascade:
        model = build_model(stage2_cfg(load_config, "ioun"), device="cpu")
        flat.update({k: v for k, v in to_flat(model).items()
                     if k.split("/")[2].startswith(CASCADE_PREFIXES)})
    return flat


def stage2_batch(stage: str, n_crops: int = 4, npoints: int = 128,
                 seed: int = 4):
    """A TRAIN crop batch of the JAX package's BoxPlaceDataset (with the
    cascade jitter for stage ioun), train_mask the predicted mask."""
    from ws3d_tpu.config import load_config
    from ws3d_tpu.datasets.boxplace_dataset import (
        BoxPlaceDataset, synthetic_proposal_database)
    cfg = stage2_cfg(load_config, stage, npoints)
    db = synthetic_proposal_database(num=16, seed=seed, crop_points=npoints)
    ds = BoxPlaceDataset(db, cfg, mode="TRAIN", npoints=npoints, seed=seed)
    return next(ds.batches(n_crops, steps=1))


def jax_stage2_gradients(stage: str, batch, npoints: int = 128,
                         dtype: str = "float32"):
    """(loss, aux, {npz key: gradient}) of the JAX package's stage-2 step
    (make_rcnn_loss_fn + jax.value_and_grad) from the fitted weights, in
    TPU.COMPUTE_DTYPE `dtype`."""
    import jax
    import jax.numpy as jnp
    from flax.traverse_util import flatten_dict, unflatten_dict
    from ws3d_tpu.config import load_config
    from ws3d_tpu.models import build_model, init_model
    from ws3d_tpu.training.trainer import make_rcnn_loss_fn
    cfg = stage2_cfg(load_config, stage, npoints, dtype)
    model = build_model(cfg)
    variables = init_model(model, cfg, jax.random.PRNGKey(0))
    flat = stage2_flat_weights(stage == "ioun")
    f = flatten_dict(jax.tree.map(np.asarray, variables["params"]))
    assert len(f) == len(flat)
    params = unflatten_dict({k: flat["params/" + "/".join(k)] for k in f})
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()
              if k not in ("sample_id", "box_id")}
    (loss, (aux, _)), grads = jax.jit(jax.value_and_grad(
        make_rcnn_loss_fn(model, cfg, stage), has_aux=True))(
        params, {}, jbatch, jax.random.PRNGKey(1), jnp.float32(0.1))
    grads = {"params/" + "/".join(k): np.asarray(v)
             for k, v in flatten_dict(grads).items()}
    return float(loss), {k: np.asarray(v) for k, v in aux.items()}, grads


def torch_stage2_model(stage: str, npoints: int = 128,
                       dtype: str = "float32"):
    """(model on the CPU with the fitted stage-2 weights, cfg) of the
    port, in TPU.COMPUTE_DTYPE `dtype`."""
    from ws3d_tpu_torch.config import load_config
    from ws3d_tpu_torch.models import build_model
    from ws3d_tpu_torch.weights import load_flat
    cfg = stage2_cfg(load_config, stage, npoints, dtype)
    model = build_model(cfg, device="cpu")
    load_flat(model, stage2_flat_weights(stage == "ioun"))
    return model, cfg


def assert_gradients_match(got, ref, keys=None):
    """Every gradient of `got` ({npz key: array}) within 1e-3 of the
    largest magnitude of its JAX counterpart in `ref` (exactly zero where
    that is: a head the loss does not read)."""
    for k in (keys if keys is not None else got):
        g, r = got[k], ref[k]
        scale = np.abs(r).max()
        err = np.abs(g - r).max()
        assert err <= 1e-3 * scale, (k, err, scale)


def jax_rpn_gradients(batch, n_points: int, dtype: str = "float32"):
    """(loss, aux, {npz key: gradient}, {npz key: new BN statistic}) of the
    JAX package's stage-1 loss (make_rpn_loss_fn + jax.value_and_grad) from
    the fitted stage-1 weights, rpn_cfg at `n_points` in `dtype`, no
    dropout."""
    import jax
    import jax.numpy as jnp
    from flax.traverse_util import flatten_dict, unflatten_dict
    from ws3d_tpu.config import load_config
    from ws3d_tpu.models import build_model, init_model
    from ws3d_tpu.training.trainer import make_rpn_loss_fn
    cfg = rpn_cfg(load_config, n_points, dtype)
    model = build_model(cfg)
    variables = init_model(model, cfg, jax.random.PRNGKey(0))
    flat = rpn_flat_weights()
    tree = {}
    for coll in ("params", "batch_stats"):
        f = flatten_dict(jax.tree.map(np.asarray, variables[coll]))
        tree[coll] = unflatten_dict({k: flat[coll + "/" + "/".join(k)]
                                     for k in f})
    jbatch = {k: jnp.asarray(batch[k])
              for k in ("pts_input", "rpn_cls_label", "rpn_reg_label")}
    (loss, (aux, new_bs)), grads = jax.jit(jax.value_and_grad(
        make_rpn_loss_fn(model, cfg), has_aux=True))(
        tree["params"], tree["batch_stats"], jbatch, jax.random.PRNGKey(1),
        jnp.float32(0.1))

    def npz(t, coll):
        return {coll + "/" + "/".join(k): np.asarray(v)
                for k, v in flatten_dict(t).items()}
    return (float(loss), {k: np.asarray(v) for k, v in aux.items()},
            npz(grads, "params"), npz(new_bs, "batch_stats"))


# The greedy sweep's cases (ops/nms.greedy_suppress), shared by the plain
# path's test against the JAX package (test_torch_greedy_sweep.py) and the
# kernel's test on the card (test_torch_cuda.py): name -> (leading shape,
# K). Each is made by sweep_case from a seed.
SWEEP_CASES = {"k1": ((), 1), "ties": ((2,), 40), "nan": ((2, 3), 48),
               "asymmetric": ((3,), 64), "all_invalid": ((2,), 33),
               "all_valid": ((), 33), "all_suppress": ((2, 2), 32),
               "none_suppress": ((1,), 31), "ties_inexact": ((2,), 40)}
SWEEP_THRESH = 0.5
# a threshold f32 cannot hold (rotated_nms takes RPN_NMS_THRESH values such
# as 0.85): the sweep compares against its f32 rounding, as `pair > thresh`
# does on an f32 tensor
SWEEP_THRESH_INEXACT = 0.85


def sweep_case(name: str, seed: int = 0):
    """(pair (..., K, K) f32, valid (..., K) bool, thresh) of SWEEP_CASES
    `name`: entries on both sides of SWEEP_THRESH, the matrix never
    symmetric; `ties` puts a third of them exactly at it, `ties_inexact`
    a third each at float32(SWEEP_THRESH_INEXACT) and its two neighbouring
    f32 values (thresh SWEEP_THRESH_INEXACT), `nan` a tenth at NaN,
    `asymmetric` every entry on and below the diagonal above it."""
    lead, K = SWEEP_CASES[name]
    rng = np.random.RandomState(seed)
    pair = rng.uniform(0.0, 0.6, lead + (K, K)).astype(np.float32)
    valid = rng.rand(*lead, K) < 0.8
    if name == "ties":
        pair = rng.choice(np.float32([0.4, SWEEP_THRESH, 0.6]),
                          lead + (K, K))
    elif name == "ties_inexact":
        at = np.float32(SWEEP_THRESH_INEXACT)
        pair = rng.choice(np.float32([np.nextafter(at, np.float32(0)), at,
                                      np.nextafter(at, np.float32(1))]),
                          lead + (K, K))
        return pair, valid, SWEEP_THRESH_INEXACT
    elif name == "nan":
        pair[rng.rand(*pair.shape) < 0.1] = np.nan
    elif name == "asymmetric":
        pair[..., np.tril(np.ones((K, K), bool))] = 1.0
    elif name == "all_invalid":
        valid[:] = False
    elif name == "all_valid":
        valid[:] = True
    elif name == "all_suppress":
        pair[:] = 1.0
    elif name == "none_suppress":
        pair[:] = 0.0
    return pair, valid, SWEEP_THRESH
