"""Process start to the first timed unit: imports, the inputs, the program's
objects and builds, the judged units and the warm-up."""


def read(run):
    return run.setup_s
