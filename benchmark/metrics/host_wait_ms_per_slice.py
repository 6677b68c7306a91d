"""host_wait_ms_per_slice: host ms per slice of every "read:" span of the
window: the host's waits for the device to reach a read of its memory."""

from ..program_spans import READ, window_spans


def read(run):
    spans = window_spans(run)
    reads = [s for s in spans or () if s.name.startswith(READ)]
    if not reads:
        return None
    return sum(s.host_ms for s in reads) / run.n_slices
