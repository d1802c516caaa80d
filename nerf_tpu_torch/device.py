"""Device resolution shared by every entry point of the port.

The port runs on the CUDA device unless the caller asks for the CPU.  With
no card and no ``device="cpu"`` it raises: it never carries on quietly on the
CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "nerf_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return dev


def check_device(t: torch.Tensor, dev: torch.device, name: str) -> None:
    """Raise unless tensor ``t`` lies on the device type of ``dev``."""
    if t.device.type != dev.type:
        raise ValueError(f"{name} is on {t.device}, expected {dev.type}")
