"""Traffic kinds: the code that drives a traffic mix's data."""
