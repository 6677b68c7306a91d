"""host_enqueue_ms_per_slice: host ms per slice of the program's "slice
step" spans less the "read:" spans inside them: the host's time to launch a
slice's work, apart from its waits for the device."""

from ..program_spans import reads_inside, window_spans


def read(run):
    spans = window_spans(run)
    steps = [s for s in spans or () if s.name == "slice step"]
    if not steps:
        return None
    ms = sum(s.host_ms - sum(r.host_ms for r in reads_inside(spans, s))
             for s in steps)
    return ms / run.n_slices
