"""The whole slice with the trunk budget on: make_two_stage_fn of both
packages with RCNN_BUDGET_PER_SCENE = 4 (B = 4, K = 8: V1 = 16 of 32 slots),
so the top-V1 selection by RPN score, `spilled` and the scatter-back into
the B*K layout run; once alone (V2 = min(round8(4 * 28), 16) = V1, no
cascade cut) and once with the cascade budget 2 as well (V2 = 8). Equal
`spilled` (> 0) and `n_live`, and detection-level agreement: the same keep
set and matched boxes/scores within 1e-3."""
import pytest

from torch_port_helpers import assert_compacted_match, synthetic_batch, \
    two_stage_pair

ATOL = 1e-3


@pytest.fixture(scope="module")
def pts():
    return synthetic_batch(4, 4096, seed=3)


@pytest.mark.parametrize("ioun_budget", [28, 2], ids=["rcnn4", "rcnn4_ioun2"])
def test_trunk_budget_matches(pts, ioun_budget):
    ref, got = two_stage_pair(pts, 8, rcnn_budget=4, ioun_budget=ioun_budget)
    assert_compacted_match(ref, got, atol=ATOL)
