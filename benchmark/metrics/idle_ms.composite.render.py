"""Device idle in gaps named by the program's t3.composite spans, ms per frame."""
from spans import idle_ms


def read(run):
    return idle_ms(run, "composite")
