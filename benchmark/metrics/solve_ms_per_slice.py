"""solve_ms_per_slice: device-clock ms per slice of the program's "field
solve" spans (Psi/Ez/Bz, Sx/Sy and Bx/By, with SALAME and the fine levels'
solves inside), from the CUDA events at their ends."""

from ..program_spans import device_ms_per_slice


def read(run):
    return device_ms_per_slice(run, "field solve")
