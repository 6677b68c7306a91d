"""plasma_push_ms_per_slice: device-clock ms per slice of the program's
"plasma push" spans, from the CUDA events at their ends."""

from ..program_spans import device_ms_per_slice


def read(run):
    return device_ms_per_slice(run, "plasma push")
