"""Carry flat npz weights between the JAX package and the port's modules.

The npz keys are ``params/<path>/<leaf>`` and ``batch_stats/<path>/<leaf>``
(``ws3d_tpu/data/bench_weights.npz``: 272 arrays). The port's module tree
keeps the same names, so the key for a state-dict entry ``a.b.kernel`` is
``params/a/b/kernel`` and for a BatchNorm buffer ``a.b.mean`` it is
``batch_stats/a/b/mean``. Dense kernels are (Cin, Cout) in both.

A variables tree of the JAX package, as nested dicts of numpy arrays,
flattens to the same keys (flat_variables), so a module whose names follow
the JAX module's (the T-Net, the segmentation net's head, the 3-input SA0
of RPN.USE_INTENSITY=False) loads a seeded JAX init with load_variables.

Loading is all-or-nothing, like ws3d_tpu/utils/npz_overlay.py: every
parameter and buffer of the model is set and every npz key is consumed, or
it raises and the model is left unchanged. to_flat / save_npz go the other
way, so weights trained by the port load into the JAX package through
ws3d_tpu/utils/npz_overlay.py.
"""
from __future__ import annotations

from typing import Dict, Mapping

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


def flat_variables(variables: Mapping) -> Dict[str, np.ndarray]:
    """{collection: {name: ... {leaf: array}}} -> {npz key: array}."""
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, Mapping):
                walk(v, prefix + (k,))
            else:
                flat["/".join(prefix + (k,))] = np.array(v)
    walk(variables, ())
    return flat


def load_variables(model: nn.Module, variables: Mapping) -> int:
    """load_flat of a nested variables tree (flat_variables)."""
    return load_flat(model, flat_variables(variables))


def to_flat(model: nn.Module) -> Dict[str, np.ndarray]:
    """{npz key: float32 array} of every parameter and buffer of `model`
    (the inverse of load_flat)."""
    return {npz_key(k): v.detach().cpu().numpy().astype(np.float32)
            for k, v in model.state_dict().items()}


def save_npz(model: nn.Module, path: str) -> int:
    """Write to_flat(model) to `path` (uncompressed npz); returns the number
    of arrays."""
    flat = to_flat(model)
    np.savez(path, **flat)
    return len(flat)
