"""The host's self time in the program's t3.warp spans, ms per step."""
from spans import host_ms


def read(run):
    return host_ms(run, "warp")
