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


def card_line(index: int = 0) -> str:
    """The name and power limit of CUDA card `index`, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
    them (a device measurement names the card it ran on)."""
    import subprocess
    out = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]
