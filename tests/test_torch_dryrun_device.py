"""The dryrun's default device: ws3d_tpu_torch.parallel.dryrun runs on the
card unless asked for the CPU (device.resolve_device), one card a rank
over NCCL; on a machine with fewer cards than ranks it raises the launch's
"more ranks than visible cards" error before any rank starts, and never
switches to gloo."""
import pytest
import torch

from ws3d_tpu_torch.parallel import dryrun, mesh


def test_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        dryrun.dryrun_multichip(2)


@pytest.mark.parametrize("argv", [["2"], ["2", "--device", "cuda"]])
def test_one_card_two_ranks_raises(monkeypatch, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    started = []
    monkeypatch.setattr(mesh, "_rank_main", lambda *a: started.append(a))
    with pytest.raises(RuntimeError, match="NCCL needs a CUDA device of its "
                                           "own for each rank: 2 ranks"):
        dryrun.main(argv)
    assert started == []


class _Stop(Exception):
    pass


def test_cpu_keeps_gloo(monkeypatch):
    seen = {}

    def launch(fn, n, device=None, timeout=None):
        seen.update(n=n, device=device)
        raise _Stop                    # before any rank starts
    monkeypatch.setattr("ws3d_tpu_torch.parallel.launch", launch)
    with pytest.raises(_Stop):
        dryrun.main(["2", "--device", "cpu"])
    assert seen == {"n": 2, "device": "cpu"}
