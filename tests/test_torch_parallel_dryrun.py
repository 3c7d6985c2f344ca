"""ws3d_tpu_torch.parallel.dryrun.dryrun_multichip: the JAX dryrun's three
suites (the RPN and IOUN steps, two-stage inference in f32 and bf16) at its
shapes and bounds, over gloo ranks on the CPU."""
import pytest

from ws3d_tpu_torch.parallel.dryrun import dryrun_multichip


def _run(n):
    lines = []
    dryrun_multichip(n, device="cpu", timeout=900, log=lines.append)
    assert len(lines) == 4
    assert all(line.endswith("OK") for line in lines), lines
    return lines


def test_dryrun_two_ranks():
    lines = _run(2)
    assert "exact_parity=" in lines[0] and "live proposals" in lines[2]


@pytest.mark.slow
def test_dryrun_four_ranks():
    _run(4)
