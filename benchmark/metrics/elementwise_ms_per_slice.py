"""elementwise_ms_per_slice: device milliseconds per slice of PyTorch's
elementwise kernels (the pushers and the field algebra), grouped by the
frozen GROUPS."""

from .. import yardstick as ys


def read(run):
    ns = sum(e - s for name, s, e in run.in_window()
             if ys.group_of(name) == "elementwise")
    if not ns:
        return None
    return ns / 1e6 / run.n_slices
