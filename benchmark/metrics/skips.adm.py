"""Steps the loss scale skipped (the program's t3.skip spans), per step;
None where the trace holds no t3. span."""
from spans import PREFIX, spans_of


def read(run):
    spans = spans_of(run.trace)
    if not spans or not run.trace.frames:
        return None
    return sum(name == PREFIX + "skip" for name, _, _ in spans) / run.trace.frames
