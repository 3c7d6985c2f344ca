"""Train-state checkpoints with torch.save (port of the resume checkpoints
and load_part_checkpoint of ws3d_tpu/training/checkpoint.py).

One file holds the step, the model's state dict (weights and BatchNorm
running statistics) and the optimizer's moments. Loading uses
``weights_only=True``: the payload is tensors, dicts and ints only.
"""
from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from ws3d_tpu_torch.training.optim import AdamOneCycle


def save_train_state(path: str, model: nn.Module,
                     optimizer: AdamOneCycle) -> str:
    """Write the train state to `path` (its directory is made) and return
    the path. The file is written beside and then renamed, so a crash
    leaves the previous checkpoint whole."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {"step": int(optimizer.count),
               "model": {k: v.detach().cpu()
                         for k, v in model.state_dict().items()},
               "optimizer": optimizer.state_dict()}
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def restore_train_state(path: str, model: nn.Module,
                        optimizer: AdamOneCycle) -> int:
    """Load a checkpoint written by save_train_state into `model` and
    `optimizer` (strict: every key must match); returns its step."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(ckpt["model"], strict=True)
    optimizer.load_state_dict(ckpt["optimizer"])
    if optimizer.count != int(ckpt["step"]):
        raise RuntimeError(f"{path}: step {ckpt['step']} but optimizer "
                           f"count {optimizer.count}")
    return optimizer.count


def load_part_checkpoint(model: nn.Module, path: str,
                         subtrees=("rpn", "rcnn")) -> int:
    """Graft the entries of the top-level `subtrees` (e.g. "rcnn") from a
    checkpoint into `model`: a train state written by save_train_state, or
    an npz of flat weights (weights.save_npz or the JAX package's keys).
    Entries the checkpoint lacks stay as they are, so an IOUN model warms
    from an RCNN-only checkpoint with a fresh cascade; entries `model` lacks
    are ignored. Returns the number of tensors set."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            loaded = {k.split("/", 1)[1].replace("/", "."): torch.from_numpy(
                np.asarray(z[k], np.float32)) for k in z.files}
    else:
        loaded = torch.load(path, map_location="cpu",
                            weights_only=True)["model"]
    state = model.state_dict()
    new = {}
    for k, v in loaded.items():
        if k.split(".", 1)[0] not in subtrees or k not in state:
            continue
        if tuple(v.shape) != tuple(state[k].shape):
            raise RuntimeError(f"{path}: {k} has shape {tuple(v.shape)}, "
                               f"the model {tuple(state[k].shape)}")
        new[k] = v
    model.load_state_dict(new, strict=False)
    return len(new)
