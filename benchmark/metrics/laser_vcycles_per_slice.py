"""laser_vcycles_per_slice: the envelope solve's V-cycles per slice, from
run_step's laser_cycles counter (recorded by a traffic kind that carries
the envelope as laser_cycles on the traced run)."""


def read(run):
    cycles = getattr(run, "laser_cycles", None)
    if not cycles or not any(cycles):
        return None
    return sum(cycles) / len(cycles)
