"""launches_per_slice: the device activities (kernels, copies, sets) of the
traced window per slice."""


def read(run):
    events = run.in_window()
    if not events:
        return None
    return len(events) / run.n_slices
