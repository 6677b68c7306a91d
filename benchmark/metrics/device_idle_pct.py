"""device_idle_pct: the share of the traced window in which no kernel,
copy or set ran on the card (the union of the device's activity
intervals), in percent."""


def read(run):
    if run.window_s <= 0 or not run.events:
        return None
    return 100.0 * (1.0 - run.busy_s() / run.window_s)
