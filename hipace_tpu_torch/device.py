"""Device and dtype policy.

CPU runs are float64 parity runs against the JAX package's x64 results.
CUDA runs are float32 (the production type) or float64. Asking for CUDA on
a machine without a usable GPU raises: nothing silently runs on the CPU.
"""

from __future__ import annotations

import torch


def resolve(device=None, dtype=None) -> tuple[torch.device, torch.dtype]:
    """Return the (device, dtype) a run uses; raise on unsupported pairs."""
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False")
        dt = torch.float32 if dtype is None else dtype
        if dt not in (torch.float32, torch.float64):
            raise ValueError(f"CUDA runs are float32 or float64, not {dt}")
        return dev, dt
    if dev.type == "cpu":
        dt = torch.float64 if dtype is None else dtype
        if dt != torch.float64:
            raise ValueError("CPU runs are float64 parity runs")
        return dev, dt
    raise ValueError(f"unsupported device {dev}")
