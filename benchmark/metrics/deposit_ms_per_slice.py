"""deposit_ms_per_slice: device-clock ms per slice of the program's
"deposit" spans (the plasma's fused deposits, the beam's This deposit, the
fine levels', AddRhoIons, the grid current; the beam's Next jx/jy deposit),
from the CUDA events at their ends."""

from ..program_spans import device_ms_per_slice


def read(run):
    return device_ms_per_slice(run, "deposit")
