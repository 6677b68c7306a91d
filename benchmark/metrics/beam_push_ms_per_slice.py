"""beam_push_ms_per_slice: device-clock ms per slice of the program's "beam
push" spans (the subcycles, and the split of the lanes into slip and emit
with its two reads of the device), from the CUDA events at their ends."""

from ..program_spans import device_ms_per_slice


def read(run):
    return device_ms_per_slice(run, "beam push")
