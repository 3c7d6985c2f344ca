"""The whole slice: make_two_stage_fn of both packages on synthetic scenes
from the JAX loader (N = 4096, K = 8, full widths, fitted npz). Equal
`spilled` and `n_live`, the same proposal slots, and detection-level
agreement: the same keep set and matched boxes/scores within 1e-3."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_helpers import jax_detector, n, synthetic_batch, t, \
    torch_detector
from ws3d_tpu.pipeline import make_two_stage_fn as jax_two_stage
from ws3d_tpu_torch.pipeline import make_two_stage_fn

ATOL = 1e-3


@pytest.fixture(scope="module")
def runs():
    pts = synthetic_batch(4, 4096, seed=3)
    jmodel, variables, cfg = jax_detector()
    ref = jax.jit(jax_two_stage(jmodel, cfg, max_proposals=8))(
        variables, jnp.asarray(pts))
    tmodel, tcfg = torch_detector()
    got = make_two_stage_fn(tmodel, tcfg, max_proposals=8)(t(pts))
    return ({k: np.asarray(v) for k, v in ref.items()},
            {k: n(v) for k, v in got.items()})


def test_counts_and_slots_match(runs):
    ref, got = runs
    assert int(got["spilled"]) == int(ref["spilled"])
    assert int(got["n_live"]) == int(ref["n_live"]) > 0
    np.testing.assert_array_equal(got["proposal_valid"],
                                  ref["proposal_valid"])
    np.testing.assert_allclose(got["centers"], ref["centers"], atol=1e-4)


def test_detections_match(runs):
    ref, got = runs
    assert ref["keep"].any()
    np.testing.assert_array_equal(got["keep"], ref["keep"])
    live = ref["proposal_valid"]
    np.testing.assert_allclose(got["boxes"][live], ref["boxes"][live],
                               atol=ATOL, rtol=1e-4)
    np.testing.assert_allclose(got["scores"][live], ref["scores"][live],
                               atol=ATOL, rtol=1e-4)
    assert got["packed"].shape == ref["packed"].shape == (4, 8, 9)
    np.testing.assert_array_equal(got["packed"][..., 8] > 0.5, got["keep"])
