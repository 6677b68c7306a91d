"""mg_vcycles_per_slice: the explicit Bx/By solve's V-cycles per slice, from
run_step's mg_cycles counter."""


def read(run):
    if not run.mg_cycles or not any(run.mg_cycles):
        return None
    return sum(run.mg_cycles) / len(run.mg_cycles)
