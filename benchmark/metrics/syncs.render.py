"""Host syncs inside the program's t3.path spans, per frame."""
from spans import syncs


def read(run):
    return syncs(run)
