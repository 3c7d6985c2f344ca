"""The whole slice with the cascade budget on: make_two_stage_fn of both
packages with IOUN_BUDGET_PER_SCENE so low that the top-V2 gate, `spilled`
and the scatter-back run (B = 4, K = 8: V = 32 trunk slots, budget 2 gives
V2 = 8). Equal `spilled` (> 0) and `n_live`, and detection-level agreement:
the same keep set and matched boxes/scores within 1e-3."""
import pytest

from torch_port_helpers import assert_compacted_match, synthetic_batch, \
    two_stage_pair

ATOL = 1e-3


@pytest.fixture(scope="module")
def runs():
    pts = synthetic_batch(4, 4096, seed=3)
    return two_stage_pair(pts, 8, rcnn_budget=0, ioun_budget=2)


def test_cascade_budget_matches(runs):
    assert_compacted_match(*runs, atol=ATOL)
