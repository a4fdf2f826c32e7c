"""Device idle in gaps named by the program's t3.forward spans, ms per step."""
from spans import idle_ms


def read(run):
    return idle_ms(run, "forward")
