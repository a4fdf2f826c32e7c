"""Host syncs inside the program's t3.step spans, per step."""
from spans import syncs


def read(run):
    return syncs(run)
