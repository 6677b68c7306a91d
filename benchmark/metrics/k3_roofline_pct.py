"""k3_roofline_pct: K3's least time over its traced device time, summed over
its solves, in percent: one explicit Bx/By solve per slice (C = 2, a 2-D
a-coefficient) at the V-cycles that run_step counted for the slice
(yardstick.k3_counts). Nothing is read where the trace's K3 launches are not
the slices' solves one for one."""

from .. import yardstick as ys


def read(run):
    times = [e - s for name, s, e in run.in_window() if ys.K3_NAME in name]
    if not times or len(times) != len(run.mg_cycles):
        return None
    nx, ny, _ = run.config["amr.n_cell"]
    size = 8 if run.config["dtype"] == "float64" else 4
    least = sum(ys.bound_s(*ys.k3_counts(2, nx, ny, c, size), size)
                for c in run.mg_cycles)
    return 100.0 * least / (sum(times) / 1e9)
