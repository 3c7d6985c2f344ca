"""Shared helpers for the tests that hold ws3d_tpu_torch against ws3d_tpu.

Both packages get the same inputs, made with numpy from a seed; JAX runs on
the CPU (tests/conftest.py) and the port on CPU tensors, where every kernel
wrapper runs its plain PyTorch version.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch

# six xdist workers share the machine
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "ws3d_tpu", "data", "bench_weights.npz")


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
