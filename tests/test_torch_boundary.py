"""The port's import boundary and its device contract."""
import ast
import os
import subprocess
import sys

import pytest
import torch

from torch_port_helpers import REPO

# JAX and its libraries; the repo's tools/ (tools/common.py imports JAX)
BANNED = ("jax", "flax", "optax", "orbax", "tools", "common")


# the card's test files, run with --noconftest on a machine that may have
# no JAX (torch_port_helpers.py is not one: its JAX references import JAX)
CARD_TESTS = ("test_torch_cuda.py", "test_torch_bn_relu.py",
              "torch_parallel_ranks.py", "test_torch_card_paths.py",
              "torch_card_helpers.py")


def _port_files():
    out = [os.path.join(REPO, "tests", f) for f in CARD_TESTS]
    for root, dirs, files in os.walk(os.path.join(REPO, "ws3d_tpu_torch")):
        dirs[:] = [d for d in dirs if d != "_build"]       # build outputs
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_package_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        # `ws3d_tpu_torch` shares the prefix: only the exact name is banned
        assert top not in BANNED and top != "ws3d_tpu", (path, mod)


def test_import_leaves_jax_unloaded():
    code = ("import sys, ws3d_tpu_torch.pipeline, ws3d_tpu_torch.datasets, "
            "ws3d_tpu_torch.weights, ws3d_tpu_torch.training, "
            "ws3d_tpu_torch.losses, ws3d_tpu_torch.ops.ball_query, "
            "ws3d_tpu_torch.tools.train_rpn, ws3d_tpu_torch.tools.eval_auto, "
            "ws3d_tpu_torch.eval, ws3d_tpu_torch.native, "
            "ws3d_tpu_torch.tools.eval_active, "
            "ws3d_tpu_torch.tools.pointnet2_seg, "
            "ws3d_tpu_torch.tools.annotate, ws3d_tpu_torch.tools.gpu_selftest, "
            "ws3d_tpu_torch.tools.train_cascade1, "
            "ws3d_tpu_torch.tools.train_cascade_later, "
            "ws3d_tpu_torch.pipeline.proposal_layer, "
            "ws3d_tpu_torch.pipeline.roi_target, "
            "ws3d_tpu_torch.models.transformer, "
            "ws3d_tpu_torch.utils.profiling; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'ws3d_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_entry_points_need_an_explicit_cpu_request(monkeypatch, tmp_path):
    from ws3d_tpu_torch.config import load_config
    from ws3d_tpu_torch.device import resolve_device
    from ws3d_tpu_torch.models import build_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        build_model(load_config())
    from ws3d_tpu_torch.tools import train_rpn
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_rpn.main(["--synthetic", "--steps", "1", "--scenes", "2",
                        "--batch", "1", "--points", "256",
                        "--output_dir", str(tmp_path)])
    assert resolve_device("cpu").type == "cpu"


def test_cuda_wrappers_refuse_cpu_tensors():
    from ws3d_tpu_torch.ops import (ball_query, crop_gather, fused_sa,
                                    interpolate, sampling)
    x = torch.zeros(1, 128, 3)
    with pytest.raises(ValueError):
        ball_query.ball_query_multi_cuda([0.5], [8], x, x[:, :8])
    with pytest.raises(ValueError):
        interpolate.three_nn_cuda(x, x)
    with pytest.raises(ValueError):
        sampling.fps_cuda(x, 8)
    with pytest.raises(ValueError):
        interpolate.three_interpolate_cuda(x, x, torch.zeros(1, 128, 4))
    with pytest.raises(ValueError):
        crop_gather.crop_gather_cuda(x, torch.zeros(1, 5, 128),
                                     torch.zeros(1, 8, 2), 4.0, 16)
    with pytest.raises(ValueError):
        fused_sa.fused_sa_cuda(x, torch.zeros(1, 128, 1), x[:, :8], 0.5, 8,
                               [torch.zeros(4, 8)], [torch.zeros(8)], False)
