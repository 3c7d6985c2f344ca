"""The greedy sweep (ops/nms.greedy_suppress) on CPU tensors: its plain
version against the JAX package's _greedy_suppress on the cases the
kernel's test on the card shares (torch_port_helpers.SWEEP_CASES), and
its step counter."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import SWEEP_CASES, n, sweep_case, t
from ws3d_tpu.ops.nms import _greedy_suppress
from ws3d_tpu_torch.ops.nms import greedy_suppress, greedy_suppress_plain
from ws3d_tpu_torch.utils.profiling import TRACE


def _rows(pair, valid):
    """The cases' leading rows: (K, K) and (K,) pairs."""
    K = pair.shape[-1]
    return zip(pair.reshape(-1, K, K), valid.reshape(-1, K))


@pytest.mark.parametrize("name", sorted(SWEEP_CASES))
def test_plain_sweep_matches_jax(name):
    pair, valid, thresh = sweep_case(name)
    got = n(greedy_suppress_plain(t(pair), thresh, t(valid)))
    assert got.shape == valid.shape and got.dtype == np.bool_
    ref = [np.asarray(_greedy_suppress(jnp.asarray(p), thresh,
                                       jnp.asarray(v)))
           for p, v in _rows(pair, valid)]
    np.testing.assert_array_equal(got.reshape(len(ref), -1), np.stack(ref))


@pytest.mark.parametrize("K", [31, 32, 33, 64])
def test_plain_sweep_matches_jax_by_size(K):
    rng = np.random.RandomState(K)
    pair = rng.rand(2, K, K).astype(np.float32)
    valid = rng.rand(2, K) < 0.9
    got = n(greedy_suppress_plain(t(pair), 0.9, t(valid)))
    for i in range(2):
        ref = _greedy_suppress(jnp.asarray(pair[i]), 0.9,
                               jnp.asarray(valid[i]))
        np.testing.assert_array_equal(got[i], np.asarray(ref))


@pytest.mark.parametrize("name", ["k1", "nan", "all_invalid"])
def test_cpu_call_counts_k_steps(name):
    pair, valid, thresh = sweep_case(name)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        keep = greedy_suppress(t(pair), thresh, t(valid))
    assert TRACE.totals()["counters"] == {"nms.sweep_steps": pair.shape[-1]}
    assert torch.equal(keep, greedy_suppress_plain(t(pair), thresh,
                                                   t(valid)))

