"""100 x (1 - the union of the kernels' intervals over the traced window)."""
from readers import idle_share


def read(run):
    return idle_share(run)
