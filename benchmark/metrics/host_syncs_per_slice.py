"""host_syncs_per_slice: the device-to-host copies of the traced window per
slice; each is a read of the device that the host waits for."""

from .. import yardstick as ys


def read(run):
    events = run.in_window()
    if not events:
        return None
    return sum(ys.DTOH in name for name, _, _ in events) / run.n_slices
