"""Device and dtype policy.

A run is on the card unless the caller asks for the CPU: CUDA in float32
(the production type) or float64. Without a usable GPU that raises; nothing
silently runs on the CPU. ``device="cpu"`` asks for the float64 parity run
against the JAX package's x64 results, as the tests do.
"""

from __future__ import annotations

import subprocess

import torch


def resolve(device=None, dtype=None) -> tuple[torch.device, torch.dtype]:
    """Return the (device, dtype) a run uses; raise on unsupported pairs.
    `device=None` is the card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a CUDA device is needed but torch.cuda.is_available() is "
                "False; pass device='cpu' (--device cpu) for the float64 "
                "CPU run")
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


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them (its
    first line), or "not read"."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=False, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    lines = smi.stdout.strip().splitlines()
    return lines[0] if smi.returncode == 0 and lines else "not read"
