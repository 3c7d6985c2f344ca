"""Carry the JAX package's flat npz weights into the port's modules.

The npz keys are ``params/<path>/<leaf>`` and ``batch_stats/<path>/<leaf>``
(``ws3d_tpu/data/bench_weights.npz``: 272 arrays). The port's module tree
keeps the same names, so the key for a state-dict entry ``a.b.kernel`` is
``params/a/b/kernel`` and for a BatchNorm buffer ``a.b.mean`` it is
``batch_stats/a/b/mean``. Dense kernels are (Cin, Cout) in both.

All-or-nothing, like ws3d_tpu/utils/npz_overlay.py: every parameter and
buffer of the model is set and every npz key is consumed, or it raises and
the model is left unchanged.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

_STATS = ("mean", "var")


def npz_key(state_key: str) -> str:
    coll = "batch_stats" if state_key.rsplit(".", 1)[-1] in _STATS \
        else "params"
    return coll + "/" + state_key.replace(".", "/")


def load_flat(model: nn.Module, flat: Mapping[str, np.ndarray]) -> int:
    """Load a flat {npz key: array} mapping into `model`; returns the number
    of tensors set. Raises RuntimeError on any missing, unused or
    mis-shaped key."""
    state = model.state_dict()
    missing, mismatched, new = [], [], {}
    for key, t in state.items():
        arr = flat.get(npz_key(key))
        if arr is None:
            missing.append(npz_key(key))
        elif tuple(arr.shape) != tuple(t.shape):
            mismatched.append(f"{npz_key(key)} {tuple(arr.shape)} != "
                              f"{tuple(t.shape)}")
        else:
            new[key] = torch.from_numpy(np.asarray(arr, dtype=np.float32))
    unused = sorted(set(flat) - {npz_key(k) for k in state})
    if missing or mismatched or unused:
        raise RuntimeError(
            f"npz weight load incomplete: {len(new)}/{len(state)} tensors; "
            f"missing={missing[:5]} mismatched={mismatched[:5]} "
            f"unused={unused[:5]}")
    model.load_state_dict(new, strict=True)
    return len(new)


def load_npz(model: nn.Module, path: str) -> int:
    """Load the npz file at `path` into `model` (all-or-nothing)."""
    with np.load(path) as z:
        return load_flat(model, {k: z[k] for k in z.files})
