"""Two-stage inference data parallel over two gloo ranks
(ws3d_tpu_torch.parallel.data_parallel_infer; the JAX dryrun's third suite
and tests/test_pipeline.py's sharded-batch test). tests/test_pipeline.py's
256-point scenes give no live proposal with either the seeded or the
fitted weights, so this runs tests/test_torch_eval_auto.py's size: 4 EVAL
scenes of 4,096 points, the fitted npz, K = 8, where stage 2 runs on live
crops and keeps detections.

Each rank runs 2 scenes and the stage-2 compaction pools over the whole
batch, as jit does on a sharded batch. Under the default budgets nothing
spills: the gathered records equal the port's single-process batch within
rtol = atol = 1e-4 (tests/test_pipeline.py's tolerance) and JAX's
make_two_stage_fn within assert_compacted_match's 1e-3. Under budgets of 4
trunk and 2 cascade slots a scene the pool spills, and a rank's own pool
would hold other slots (8 + 8 cascade slots instead of 8); the sharded
batch still equals the single one, `spilled` included
(tests/test_torch_two_stage_rcnn_budget.py holds that one against JAX).
With the second rank's scenes emptied (coordinates zeroed) and a pool of
8 slots, every pooled slot lies in the first rank's scenes: the second
rank runs no stage 2 and the batch still equals the single one."""
import copy

import numpy as np
import pytest

import torch_parallel_ranks as ranks
from torch_port_helpers import (jax_detector, synthetic_batch, t,
                                torch_detector)
from ws3d_tpu_torch.parallel import launch
from ws3d_tpu_torch.pipeline import make_two_stage_fn

SCENES = 4
K = 8
WORLD = 2
# (trunk, cascade) budgets a scene: the defaults, a pool that spills, and
# one the second rank's (emptied) scenes get no slot of
BUDGETS = {"pooled": (0, 28), "spilled": (4, 2), "one_rank_idle": (2, 1)}


@pytest.fixture(scope="module")
def run():
    import jax
    import jax.numpy as jnp
    from ws3d_tpu.pipeline import make_two_stage_fn as jax_two_stage
    pts = np.asarray(synthetic_batch(SCENES, 4096))
    idle = pts.copy()
    idle[SCENES // WORLD:, :, :3] = 0.0
    tmodel, cfg = torch_detector()
    runs = {}
    for name, (trunk, cascade) in BUDGETS.items():
        c = copy.deepcopy(cfg)
        c.TPU.RCNN_BUDGET_PER_SCENE = trunk
        c.TPU.IOUN_BUDGET_PER_SCENE = cascade
        runs[name] = (c, idle if name == "one_rank_idle" else pts)
    got = launch(ranks.infer_rank, WORLD, runs, K, device="cpu",
                 timeout=600)
    single = {name: {k: v.numpy() for k, v in make_two_stage_fn(
        tmodel, c, max_proposals=K)(t(p)).items()}
        for name, (c, p) in runs.items()}
    jmodel, variables, jcfg = jax_detector()
    ref = jax.jit(jax_two_stage(jmodel, jcfg, max_proposals=K))(
        variables, jnp.asarray(pts))
    return ([{name: {k: v.numpy() for k, v in g[name].items()}
              for name in BUDGETS} for g in got],
            single, {k: np.asarray(v) for k, v in ref.items()})


@pytest.mark.parametrize("name", list(BUDGETS))
def test_ranks_gather_the_same_record(run, name):
    got, _, _ = run
    for k in got[0][name]:
        np.testing.assert_array_equal(got[1][name][k], got[0][name][k],
                                      err_msg=k)


@pytest.mark.parametrize("name", list(BUDGETS))
def test_sharded_equals_single_process(run, name):
    got, single, _ = run
    got, single = got[0][name], single[name]
    assert got["spilled"].shape == got["n_live"].shape == ()
    assert (int(single["spilled"]) > 0) == (name != "pooled")
    if name == "one_rank_idle":     # no slot of the second rank ran stage 2
        assert np.isneginf(single["scores"][SCENES // WORLD:]).all()
    assert int(got["spilled"]) == int(single["spilled"])
    assert int(got["n_live"]) == int(single["n_live"]) > 0
    assert single["keep"].any()
    np.testing.assert_array_equal(got["keep"], single["keep"])
    np.testing.assert_array_equal(got["proposal_valid"],
                                  single["proposal_valid"])
    for k in ("packed", "boxes", "scores", "centers"):
        np.testing.assert_allclose(got[k], single[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_sharded_equals_jax(run):
    got, _, ref = run
    got = got[0]["pooled"]
    assert int(ref["spilled"]) == int(got["spilled"]) == 0
    assert int(got["n_live"]) == int(ref["n_live"])
    np.testing.assert_array_equal(got["proposal_valid"],
                                  ref["proposal_valid"])
    np.testing.assert_array_equal(got["keep"], ref["keep"])
    live = ref["proposal_valid"]
    np.testing.assert_allclose(got["boxes"][live], ref["boxes"][live],
                               atol=1e-3, rtol=1e-4)
    np.testing.assert_allclose(got["scores"][live], ref["scores"][live],
                               atol=1e-3, rtol=1e-4)
    assert got["packed"].shape == ref["packed"].shape
