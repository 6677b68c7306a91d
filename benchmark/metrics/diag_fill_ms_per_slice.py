"""diag_fill_ms_per_slice: device-clock ms per slice of the program's
"diagnostics" spans, both of a slice: the slice step's (the stack, the
payloads, the in-situ sums) and the time step's copies of them into the
step's buffers, from the CUDA events at their ends."""

from ..program_spans import device_ms_per_slice


def read(run):
    return device_ms_per_slice(run, "diagnostics")
