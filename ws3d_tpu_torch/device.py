"""Device selection: the port runs on CUDA unless the caller asks for the
CPU, and never moves to the CPU on its own."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means CUDA, and raises when no CUDA
    device is visible (pass device='cpu' for the plain PyTorch path)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible; pass device='cpu' "
                               "to run the plain PyTorch versions")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
