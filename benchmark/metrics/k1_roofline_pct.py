"""k1_roofline_pct: K1's least time over its traced device time, summed over
its calls, in percent. Each call's least time is the larger of its bytes
over the HBM rate and its operations over the FLOP peak of its dtype,
counted from the call's shapes (yardstick.k1_counts; every lane counted as
depositing); the time is the kernel's in the trace. Nothing is read where
the trace's K1 launches are not the recorded calls one for one."""

from .. import yardstick as ys


def read(run):
    times = [e - s for name, s, e in run.in_window() if ys.K1_NAME in name]
    if not times or len(times) != len(run.k1_calls):
        return None
    least = sum(ys.bound_s(*ys.k1_counts(C, n, NY, NX, size), size)
                for C, n, NY, NX, size in run.k1_calls)
    return 100.0 * least / (sum(times) / 1e9)
