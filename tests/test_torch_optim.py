"""The port's schedules and AdamOneCycle against the JAX package's optax
chain (build_optimizer): the same NumPy gradients for 5 steps give the
same parameters within 1e-6, with and without clipping; the optimizer
state survives a checkpoint."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ws3d_tpu.config import load_config as jax_config
from ws3d_tpu.training.optim import (bn_momentum_schedule as jax_bn_sched,
                                     build_optimizer, onecycle_momentum as
                                     jax_mom, onecycle_schedule as jax_lr)
from ws3d_tpu_torch.config import load_config
from ws3d_tpu_torch.training import checkpoint
from ws3d_tpu_torch.training.optim import (AdamOneCycle,
                                           bn_momentum_schedule,
                                           onecycle_momentum,
                                           onecycle_schedule)


@pytest.mark.parametrize("total", [10, 100, 8000])
def test_schedules_match_jax(total):
    lr, jlr = onecycle_schedule(total, 0.002), jax_lr(total, 0.002)
    mom, jm = onecycle_momentum(total), jax_mom(total)
    for step in sorted({0, 1, total // 3, int(total * 0.4), total - 1,
                        total, total + 5}):
        np.testing.assert_allclose(lr(step), float(jlr(step)), rtol=1e-6)
        np.testing.assert_allclose(mom(step), float(jm(step)), rtol=1e-6)
    cfg, jcfg = load_config(), jax_config()
    for epoch in (0, 999, 1000, 5000):
        assert bn_momentum_schedule(cfg)(epoch) == jax_bn_sched(jcfg)(epoch)


@pytest.mark.parametrize("grad_scale", [0.01, 10.0])   # below/above clip
def test_adam_onecycle_matches_optax(rng, grad_scale):
    shapes = {"a/kernel": (6, 5), "a/bias": (5,), "b/scale": (7,),
              "c/kernel": (3, 4)}
    init = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * grad_scale).astype(np.float32)
              for k, s in shapes.items()} for _ in range(5)]
    grads[2]["a/bias"][:] = 0.0
    total = 20
    jcfg = jax_config()
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    tx = build_optimizer(jcfg, total, jparams)
    state = tx.init(jparams)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jparams)
        jparams = optax.apply_updates(jparams, upd)

    params = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    opt = AdamOneCycle(load_config(), total, params.items())
    for g in grads:
        opt.step({k: torch.from_numpy(v) for k, v in g.items()})
    assert opt.count == 5
    for k in shapes:
        np.testing.assert_allclose(params[k].numpy(), np.asarray(jparams[k]),
                                   rtol=0, atol=1e-6)


def test_optimizer_state_round_trip(tmp_path, rng):
    model = torch.nn.Linear(4, 3)
    opt = AdamOneCycle(load_config(), 10, model.named_parameters())
    for _ in range(3):
        opt.step({k: torch.from_numpy(rng.randn(*p.shape).astype(np.float32))
                  for k, p in model.named_parameters()})
    path = checkpoint.save_train_state(str(tmp_path / "s.pt"), model, opt)
    model2 = torch.nn.Linear(4, 3)
    opt2 = AdamOneCycle(load_config(), 10, model2.named_parameters())
    assert checkpoint.restore_train_state(path, model2, opt2) == 3
    for k, p in model.named_parameters():
        assert torch.equal(p, dict(model2.named_parameters())[k])
        assert torch.equal(opt.mu[k], opt2.mu[k])
        assert torch.equal(opt.nu[k], opt2.nu[k])
    with pytest.raises(KeyError):
        opt2.step({"weight": torch.zeros(3, 4)})
