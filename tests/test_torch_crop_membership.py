"""The proposal database's device stage on the CPU: rpn_propose with a
point_valid mask and crop_membership (kernel 6w's plain version behind the
far-sentinel move of invalid points) against the JAX pipeline, on a
duplicate-padded whole-scene cloud. Exact."""
import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_helpers import n, t
from ws3d_tpu.config import load_config as jax_load_config
from ws3d_tpu.datasets import SyntheticKitti
from ws3d_tpu.datasets.rpn_dataset import RPNDataset
from ws3d_tpu.pipeline.inference import crop_membership as jax_membership
from ws3d_tpu.pipeline.inference import rpn_propose as jax_propose
from ws3d_tpu_torch.pipeline.inference import crop_membership, rpn_propose

P = 4096


@pytest.fixture(scope="module")
def padded_scene():
    """A whole scene of 3000 generated points, repeat-last padded to P."""
    ds = RPNDataset(SyntheticKitti(num_scenes=1, points_per_scene=3000,
                                   seed=5), jax_load_config(), mode="EVAL")
    sample = ds.get_whole_scene(0, max_points=P)
    assert 0 < int(sample["n_valid"]) < P
    return sample


def _rpn_outputs(rng, pts):
    cls = rng.randn(P, 1).astype(np.float32) * 2
    reg = rng.randn(P, 76).astype(np.float32) * 3
    cls[-1] = 9.0                     # the padded duplicates score high
    return cls, reg, pts[:, 0:3].copy()


def test_propose_with_point_valid_matches_jax(rng, padded_scene):
    pts, valid = padded_scene["pts_input"], padded_scene["valid"]
    cls, reg, xyz = _rpn_outputs(rng, pts)
    kw = dict(loc_scope=3.0, loc_bin_size=0.5, score_thresh=0.1,
              max_proposals=64)
    got = rpn_propose(t(cls)[None], t(reg)[None], t(xyz)[None],
                      point_valid=t(valid)[None], **kw)
    ref = jax_propose(jnp.asarray(cls), jnp.asarray(reg), jnp.asarray(xyz),
                      point_valid=jnp.asarray(valid), **kw)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(n(a[0]), np.asarray(b))
    assert n(got[2]).sum() > 0
    # the mask matters on this cloud: unmasked, a padded point proposes
    free = rpn_propose(t(cls)[None], t(reg)[None], t(xyz)[None], **kw)
    assert not np.array_equal(n(free[0]), n(got[0]))


@pytest.mark.parametrize("max_crop", [64, 2048])
def test_crop_membership_matches_jax(rng, padded_scene, max_crop):
    pts, valid = padded_scene["pts_input"], padded_scene["valid"]
    xyz = pts[:, 0:3]
    nv = int(padded_scene["n_valid"])
    centers = xyz[rng.choice(nv, 16, replace=False)][:, [0, 2]].copy()
    centers[0] = xyz[nv - 1, [0, 2]]  # beside the padded duplicates
    centers[1] = 0.0                  # an invalid slot's centre
    centers[2] = 300.0                # an empty crop
    for pv in (valid, None):
        idx, cnt = crop_membership(t(xyz), t(centers), max_crop,
                                   None if pv is None else t(pv))
        ref_idx, ref_cnt = jax_membership(
            jnp.asarray(xyz), jnp.asarray(centers), max_crop,
            None if pv is None else jnp.asarray(pv))
        np.testing.assert_array_equal(n(idx), np.asarray(ref_idx))
        np.testing.assert_array_equal(n(cnt), np.asarray(ref_cnt))
    c = n(cnt)
    assert c[0] > P - nv              # unmasked, the duplicates count
    masked = n(crop_membership(t(xyz), t(centers), max_crop, t(valid))[1])
    assert masked[0] == c[0] - (P - nv)
    assert masked[2] == 0 and (c < max_crop).any()
