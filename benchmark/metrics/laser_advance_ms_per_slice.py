"""laser_advance_ms_per_slice: device-clock ms per slice of the program's
"laser: envelope advance" spans (chi on the laser grid, the advance's rhs
and its complex solve, K3's complex path on the card), from the CUDA
events at their ends."""

from ..program_spans import device_ms_per_slice


def read(run):
    return device_ms_per_slice(run, "laser: envelope advance")
