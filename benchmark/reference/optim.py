"""Frozen copy of the optimizer and its schedules (the port's
training/optim.py, which writes out optax's chain of the upstream
adam_onecycle): clip by the global norm, Adam with the one-cycle b1,
decoupled weight decay on tensors with ndim > 1, and the one-cycle
cosine learning rate, evaluated in float32."""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Tuple

import numpy as np
import torch

_F = np.float32


def _annealing_cos(start: float, end: float, pct) -> np.float32:
    cos_out = np.cos(_F(math.pi) * pct) + _F(1.0)
    return _F(end) + _F((start - end) / 2.0) * cos_out


def onecycle_schedule(total_steps: int, lr_max: float,
                      div_factor: float = 10.0, pct_start: float = 0.4,
                      final_lr: float = 2e-6) -> Callable[[int], float]:
    """lr(step), float32."""
    a1 = max(int(total_steps * pct_start), 1)
    a2 = max(total_steps - a1, 1)
    low = lr_max / div_factor

    def schedule(step: int) -> float:
        step = _F(step)
        if step < a1:
            return float(_annealing_cos(low, lr_max,
                                        np.clip(step / _F(a1), 0, 1)))
        return float(_annealing_cos(lr_max, final_lr,
                                    np.clip((step - _F(a1)) / _F(a2), 0, 1)))

    return schedule


def onecycle_momentum(total_steps: int, moms=(0.95, 0.85),
                      pct_start: float = 0.4) -> Callable[[int], float]:
    """Adam's b1(step), float32."""
    a1 = max(int(total_steps * pct_start), 1)
    a2 = max(total_steps - a1, 1)

    def schedule(step: int) -> float:
        step = _F(step)
        if step < a1:
            return float(_annealing_cos(moms[0], moms[1],
                                        np.clip(step / _F(a1), 0, 1)))
        return float(_annealing_cos(moms[1], moms[0],
                                    np.clip((step - _F(a1)) / _F(a2), 0, 1)))

    return schedule


class AdamOneCycle:
    """adam_onecycle with gradient clipping and decoupled weight decay.

    step(grads) applies, to every named parameter in place:
      1. g *= max / ||g|| over all tensors, only when ||g|| >= max (no
         epsilon in the norm);
      2. mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu, with b1 from
         the momentum schedule and b2 = 0.99; u = mu_hat / (sqrt(nu_hat) +
         1e-8), both corrected by 1 - b ** t with the current b1 and t >= 1;
      3. u += WEIGHT_DECAY * p where p.ndim > 1;
      4. p += -lr * u.
    lr and b1 are read at the step count before it is incremented. Nothing
    is read back to the host, so a step does not wait for the device."""

    B2 = 0.99
    EPS = 1e-8

    def __init__(self, cfg, total_steps: int,
                 named_params: Iterable[Tuple[str, torch.Tensor]]):
        self.params: Dict[str, torch.Tensor] = dict(named_params)
        self.lr = onecycle_schedule(total_steps, cfg.TRAIN.LR,
                                    div_factor=cfg.TRAIN.DIV_FACTOR,
                                    pct_start=cfg.TRAIN.PCT_START)
        self.mom = onecycle_momentum(total_steps, tuple(cfg.TRAIN.MOMS),
                                     pct_start=cfg.TRAIN.PCT_START)
        self.max_norm = float(cfg.TRAIN.GRAD_NORM_CLIP)
        self.weight_decay = float(cfg.TRAIN.WEIGHT_DECAY)
        self.count = 0
        self.mu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in self.params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        if set(grads) != set(self.params):
            raise KeyError("gradients and parameters differ: "
                           f"{sorted(set(grads) ^ set(self.params))[:5]}")
        lr = _F(self.lr(self.count))
        b1 = _F(self.mom(self.count))
        b2 = _F(self.B2)
        t = self.count + 1
        bc1 = float(_F(1) - b1 ** _F(t))
        bc2 = float(_F(1) - b2 ** _F(t))
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        keep = g_norm < self.max_norm
        for k, p in self.params.items():
            g = grads[k]
            g = torch.where(keep, g, (g / g_norm) * self.max_norm)
            mu, nu = self.mu[k], self.nu[k]
            mu.copy_(float(_F(1) - b1) * g + float(b1) * mu)
            nu.copy_(float(_F(1) - b2) * (g * g) + float(b2) * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.EPS)
            if p.dim() > 1:
                u = u + self.weight_decay * p
            p.add_(u * float(-lr))
        self.count += 1

    def state_dict(self) -> dict:
        return {"count": self.count,
                "mu": {k: v.clone() for k, v in self.mu.items()},
                "nu": {k: v.clone() for k, v in self.nu.items()}}

    def load_state_dict(self, state: dict) -> None:
        for name in ("mu", "nu"):
            mine, theirs = getattr(self, name), state[name]
            if set(mine) != set(theirs):
                raise KeyError(f"optimizer state {name}: keys differ")
            for k, v in mine.items():
                v.copy_(theirs[k])
        self.count = int(state["count"])
