"""Train-mode layers against flax: BatchNorm with batch statistics and its
running-statistics update (biased variance, momentum as an argument),
SharedMLP in train mode, HeadMLP's dropout, and that the eval BN fold
never serves a train-mode forward."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import n, t
from ws3d_tpu.models.layers import BatchNorm as JaxBatchNorm
from ws3d_tpu.models.layers import SharedMLP as JaxSharedMLP
from ws3d_tpu_torch.models import layers
from ws3d_tpu_torch.weights import load_flat


def _flax_flat(variables):
    from flax.traverse_util import flatten_dict
    return {"/".join(k): np.asarray(v)
            for k, v in flatten_dict(variables).items()}


@pytest.mark.parametrize("shape,momentum", [((2, 64, 16, 8), 0.1),
                                            ((3, 100, 5), 0.02)])
def test_batchnorm_train_matches_flax(rng, shape, momentum):
    x = (rng.randn(*shape) * 3 + 1.5).astype(np.float32)
    C = shape[-1]
    variables = {"params": {"scale": rng.rand(C).astype(np.float32) + 0.5,
                            "bias": rng.randn(C).astype(np.float32)},
                 "batch_stats": {"mean": rng.randn(C).astype(np.float32),
                                 "var": rng.rand(C).astype(np.float32) + 1}}
    ref, mut = JaxBatchNorm().apply(variables, jnp.asarray(x), train=True,
                                    momentum=momentum,
                                    mutable=["batch_stats"])
    bn = layers.BatchNorm(C)
    load_flat(bn, _flax_flat(variables))
    got = bn(t(x), train=True, momentum=momentum)
    np.testing.assert_allclose(n(got), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(n(getattr(bn, k)),
                                   np.asarray(mut["batch_stats"][k]),
                                   rtol=1e-5, atol=1e-6)
    # eval mode reads the updated running statistics
    ref_eval = JaxBatchNorm().apply(
        {"params": variables["params"], **mut}, jnp.asarray(x), train=False)
    np.testing.assert_allclose(n(bn(t(x))), np.asarray(ref_eval),
                               rtol=1e-5, atol=1e-5)


def test_shared_mlp_train_matches_flax(rng):
    x = rng.randn(2, 32, 8, 7).astype(np.float32)
    jmlp = JaxSharedMLP([16, 32])
    variables = jmlp.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref, mut = jmlp.apply(variables, jnp.asarray(x), train=True,
                          bn_momentum=0.05, mutable=["batch_stats"])
    mlp = layers.SharedMLP(7, [16, 32])
    load_flat(mlp, _flax_flat(variables))
    got = mlp(t(x), train=True, bn_momentum=0.05)
    np.testing.assert_allclose(n(got), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    flat = _flax_flat(mut)
    for k, v in mlp.named_buffers():
        np.testing.assert_allclose(
            n(v), flat["batch_stats/" + k.replace(".", "/")], rtol=1e-5,
            atol=1e-6)


def test_train_forward_never_uses_the_fold(monkeypatch):
    from ws3d_tpu_torch.config import load_config
    from ws3d_tpu_torch.models import build_model
    cfg = load_config()
    cfg.RPN.NUM_POINTS = 512
    cfg.RPN.SA_CONFIG.NPOINTS = [128, 32, 16, 8]
    model = build_model(cfg, device="cpu")

    def refuse(self):
        raise AssertionError("folded() in a train-mode forward")
    monkeypatch.setattr(layers.SharedMLP, "folded", refuse)
    rng = np.random.RandomState(0)
    pts = rng.randn(2, 512, 4).astype(np.float32) * 5
    pts = pts[:, np.argsort(pts[0, :, 2], kind="stable")]
    before = model.rpn.backbone.sa_0.mlp_0.BatchNorm_0.mean.clone()
    out = model.rpn_forward({"pts_input": t(pts)}, train=True,
                            generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(out["rpn_cls"]).all()
    assert not torch.equal(before,
                           model.rpn.backbone.sa_0.mlp_0.BatchNorm_0.mean)


def test_head_dropout_is_inverted_and_seeded():
    head = layers.HeadMLP(4, [64], 3, use_bn=False, dp_ratio=0.5)
    with torch.no_grad():
        head.Dense_0.kernel.copy_(torch.eye(4).repeat(1, 16))
        head.Dense_1.kernel.copy_(torch.ones(64, 3))
    x = torch.ones(1000, 4)
    seen = []
    for seed in (1, 1, 2):
        g = torch.Generator().manual_seed(seed)
        seen.append(head(x, train=True, generator=g).detach())
    assert torch.equal(seen[0], seen[1])
    assert not torch.equal(seen[0], seen[2])
    # each output sums 64 hidden units, each kept with p 0.5 and scaled x2
    mean = float(seen[0].mean())
    assert abs(mean - 64.0) < 1.0, mean
    assert set(torch.unique(seen[0] % 2).tolist()) == {0.0}
    assert torch.equal(head(x), torch.full((1000, 3), 64.0))   # eval
    with pytest.raises(ValueError):
        head(x, train=True)


def test_init_random_follows_the_jax_initialisers():
    """flax he_normal is a normal truncated at two standard deviations and
    scaled to variance 2 / fan_in; the cls bias is the focal prior; the reg
    head's final kernel is N(0, 0.001) (ws3d_tpu/models/rpn.py)."""
    from ws3d_tpu.models.rpn import FOCAL_PRIOR_BIAS as JAX_PRIOR
    from ws3d_tpu_torch.config import load_config
    from ws3d_tpu_torch.models import build_model
    from ws3d_tpu_torch.models.rpn import FOCAL_PRIOR_BIAS
    rpn = build_model(load_config(), device="cpu", seed=3).rpn
    assert FOCAL_PRIOR_BIAS == JAX_PRIOR
    assert torch.equal(rpn.cls_head.Dense_1.bias,
                       torch.full((1,), FOCAL_PRIOR_BIAS))
    w = rpn.reg_head.Dense_1.kernel
    assert abs(float(w.std()) - 0.001) < 1e-4 and float(w.abs().max()) > 0.003
    for name, p in rpn.named_parameters():
        if name.endswith("kernel") and name != "reg_head.Dense_1.kernel":
            std = (2.0 / p.shape[0]) ** 0.5
            assert float(p.abs().max()) <= 2 * std / 0.8796256610342398 + 1e-6
            if p.numel() > 5000:
                assert abs(float(p.std()) / std - 1) < 0.05, name
        elif name.endswith(".bias") and "cls_head" not in name:
            assert not p.any(), name
