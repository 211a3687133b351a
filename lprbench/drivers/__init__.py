"""Traffic drivers, one file a loop, found by the mix's ``driver``."""
