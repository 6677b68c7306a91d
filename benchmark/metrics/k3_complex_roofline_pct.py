"""k3_complex_roofline_pct: the complex K3's least time over its traced
device time, summed over its solves, in percent: one envelope solve per
slice on the laser grid (the deck's, amr.n_cell) at the V-cycles that
run_step counted for the slice (yardstick_laser.k3_complex_counts). Its
launches are K3's instances with the complex template flag. Nothing is
read where they are not the slices' solves one for one."""

from .. import yardstick as ys
from .. import yardstick_laser as ysl


def read(run):
    cycles = getattr(run, "laser_cycles", None)
    times = [e - s for name, s, e in run.in_window()
             if ysl.is_k3_complex(name)]
    if not times or not cycles or len(times) != len(cycles):
        return None
    nx, ny, _ = run.config["amr.n_cell"]
    size = 8 if run.config["dtype"] == "float64" else 4
    least = sum(ys.bound_s(*ysl.k3_complex_counts(nx, ny, c, size), size)
                for c in cycles)
    return 100.0 * least / (sum(times) / 1e9)
