"""aabs_gather_ms_per_slice: device-clock ms per slice of the program's
"laser: |a|^2 gather" spans (|a|^2 at the plasma's lanes for the plasma
deposit, plain PyTorch), from the CUDA events at their ends."""

from ..program_spans import device_ms_per_slice


def read(run):
    return device_ms_per_slice(run, "laser: |a|^2 gather")
